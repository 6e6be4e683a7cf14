"""Launch layer, the port of `repro.launch`: the one-card mesh, pod-stacked
state, step factories and the consensus training driver.

`repro.launch.compat` has no counterpart: it holds shims over jax APIs that
moved between jax versions (`shard_map`, `make_mesh`), which have no
meaning in torch."""
