"""PyTorch / CUDA port of the adaptive filter ordering system.

``repro_torch`` mirrors the JAX package ``repro`` module for module
(``repro_torch.core.plan`` ↔ ``repro.core.plan`` and so on) and runs the
unsharded ``FilterPlan`` → ``build_session`` → ``FilterSession.step`` path
on an NVIDIA H100. Its two engines are ``"torch"`` (plain PyTorch, the
counterpart of ``jnp``) and ``"cuda"`` (hand-written kernels under
``kernels/filter_chain/csrc``, the counterpart of ``pallas``).

The package imports ``torch``, numpy and the standard library only.
"""
