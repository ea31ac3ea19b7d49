"""depthinspace_tpu_torch — the PyTorch + CUDA port of ``depthinspace_tpu``.

The JAX package beside it stays the reference. This package keeps its module
names (``ops/lcn.py`` here ports ``depthinspace_tpu/ops/lcn.py``) and its
public layouts (images ``(N, H, W)``, warp inputs NHWC, DispNet input
``(N, H, W, 2)``), so each function can be held against its counterpart on
the same numpy inputs.

What is ported so far is DIS-SF and DIS-MF: the disparity servers
(``serve.DisparityServer``, ``serve.TrackDisparityServer``), the train and
evaluation steps (``train.steps``) and the workers (``train.single_frame``,
``train.multi_frame``). Their hot kernels (census-SAD, the pattern warp by
disparity, the flow warp and the pair-indexed flow warp of FuseNet, forward
and backward) are hand-written CUDA C++ for Hopper under ``csrc/``. On a
CUDA tensor each runs its kernel or raises; on a CPU tensor it runs its
plain PyTorch version, which the tests compare with the JAX package.

The package imports torch and numpy only: never jax, flax, h5py, cv2 or the
JAX package itself.
"""

__version__ = "0.1.0"
