"""Architecture configs: one module per assigned architecture (exact
published hyperparameters), copied from `repro.configs` as data over the
port's `ModelConfig`."""
