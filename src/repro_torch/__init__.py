"""PyTorch/CUDA port of the ExpertFlow slot-buffer runtime.

Mirrors the layout of the JAX package (`configs/`, `models/`, `kernels/`,
`core/`, `runtime/`) module for module. It imports torch and numpy only;
its entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
