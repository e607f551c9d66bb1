"""PyTorch + CUDA port of the motion-diffusion framework.

Mirrors the layout of ``deepmimic_diffusion_mujoco_tpu`` (the JAX package,
which stays the reference the port is tested against). Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""
