"""HolDCSim in PyTorch: the port of the ``repro`` package to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper.

``repro_torch.core.farm.simulate`` runs the discrete-event engine's main
path on the card (``device="cpu"`` runs the plain PyTorch path).  The
package imports torch and numpy only -- never JAX or ``repro``.
"""
