"""The reference's benchmark entry points, ported: `q6bench` (kernels K3 and
K4), `gather_probe` (K5), and the device timing they share (`timing`).
`duckdb_cubit_tpu_torch.bench` is the headline benchmark (K1, K2 and the
sort-merge probe)."""
