"""duckdb_cubit_tpu_torch — the engine's PyTorch + CUDA port.

The same analytical SQL engine as `duckdb_cubit_tpu` (CUBIT bitmap index
scans, vectorized filters, exact fixed-point aggregates), written on torch
tensors and hand-written CUDA kernels for NVIDIA Hopper.  The JAX package is
the reference: every module here has its counterpart at the same path there,
and the tests hold the two against each other.

Rules of the port:
  - tensors live on the card unless the caller asks for the CPU:
    `connect(sf)` defaults to `device="cuda"`, and without a card it raises
    rather than move to the CPU;
  - each hand kernel sits behind one wrapper with two bodies, chosen only
    by the input tensor's device: a CPU tensor runs the plain torch body, a
    CUDA tensor launches the kernel or raises;
  - no module imports jax or the reference package.

Layer map (as in the reference):
  sql/ + plan/   - frontend (copied from the reference) and physical plans
  exec/          - eager executor and result rendering
  ops/           - expressions, exact sums, bitvectors, CUDA kernel wrappers
  csrc/          - CUDA C++ kernel sources, built at first use into _build/
  index/         - CUBIT bitmap index, direct-address primary-key index
  storage/       - columnar tables, dictionary encoding, zone maps, catalog
  tpch/          - TPC-H generator driver and loader
  benchmarks/    - the reference's kernel benchmarks (K3-K5) on the card
"""

__version__ = "0.1.0"
