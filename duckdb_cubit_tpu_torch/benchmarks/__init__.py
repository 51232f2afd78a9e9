"""The reference's kernel benchmarks, ported: `q6bench` (kernels K3 and
K4), `gather_probe` (K5), and the device timing they share (`timing`)."""
