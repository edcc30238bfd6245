"""The benchmark of tetra_tpu_torch, the PyTorch and CUDA port of the
multi-carrier TETRA receiver. One command runs one cell once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in BENCHMARK.json at the checkout's root, the
configuration in configs/<config>.json, the traffic mix in
traffic/<traffic>.json and each per-layer metric's reader in
layers/<metric>.py, by name: a new configuration, mix, cell or metric
is new files and entries, never an edit of the harness. The capture is
made on the card from the seed (capture.py); what the timed passes
produce is compared with the plain reference in reference/ (check.py).
Nothing here imports jax or the JAX package, and the run refuses to
print a result if either was loaded.
"""
