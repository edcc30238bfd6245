"""PyTorch + CUDA port of the production wideband receive path.

The package mirrors `tetra_tpu`'s layout (`io/`, `phy/`, `ops/`, `lmac/`,
`fastpath.py`, `rx_multi.py`) and keeps its function names. It imports
`torch` and never `jax`, and nothing of `tetra_tpu`: the host modules it
needs (`constants`, `tdma`, `umac.native_exec`, `crypto`, `io.gsmtap`,
`io.tun`) are copies held to their originals by the tests. The native
control plane builds the repository's C++ sources under `native/`.

The hand-written CUDA kernels live in `csrc/` and are built on first use
by `tetra_tpu_torch.kernels` (nvcc, sm_90a). Every kernel wrapper runs
its plain PyTorch version for CPU tensors and launches the kernel (or
raises) for CUDA tensors.
"""
