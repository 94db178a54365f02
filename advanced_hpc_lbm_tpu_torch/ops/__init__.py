"""Compute ops for the D2Q9-BGK engine.

``lattice``       — D2Q9 constants (velocities, weights, opposite permutation).
``reference``     — composable single-purpose ops, the test oracle.
``fused``         — the single-pass step in plain PyTorch and its run loop.
``kernel_common`` — the step math of the kernels in plain PyTorch.
``step_kernel``   — the per-step CUDA kernel's wrapper, plain version and
                    run.
``resident``      — the whole run in one launch per chunk: the banded CUDA
                    kernel on the small decks, the cooperative one on every
                    other grid; their wrapper and plain version.
``kstep_kernel``  — the K-steps-per-pass ghost-zone CUDA kernel's wrapper,
                    plain version and run.
``stream_kernel`` — the in-place K = 8 streaming CUDA kernel's wrapper,
                    plain version, run and single-buffer runner.
``local_kernel``  — the sharded path's per-shard kernels' wrappers and
                    plain versions.
``loop``          — the one run loop under the step, K-step, stream and
                    resident runs.
``library``       — the one boundary to the kernel library.
``mxu_collide``   — BGK collision as one (21 x 9) float32 matrix product on
                    the flat state (no backend uses it).
``_build``        — nvcc build-at-first-use of ``csrc/``, loaded with ctypes.
"""
