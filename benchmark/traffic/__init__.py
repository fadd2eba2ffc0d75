"""Traffic mixes: one module per mix, named by a workload's "traffic" key.
Each has `setup(cfg, workload, seed, device, trace)`, which returns an
object with `window(seconds)`, `layer_data()` and `check(control)`."""
