"""Launch layer, the port of `repro.launch`: the one-card mesh, pod-stacked
state, step factories and the consensus training driver."""
