"""depthinspace_tpu_torch — the PyTorch + CUDA port of ``depthinspace_tpu``.

The JAX package beside it stays the reference. This package keeps its module
names (``ops/lcn.py`` here ports ``depthinspace_tpu/ops/lcn.py``) and its
public layouts (images ``(N, H, W)``, warp inputs NHWC, DispNet input
``(N, H, W, 2)``), so each function can be held against its counterpart on
the same numpy inputs.

What is ported so far is DIS-SF, DIS-MF and DIS-FTSF: the disparity
servers (``serve.DisparityServer``, ``serve.TrackDisparityServer``), the
train and evaluation steps (``train.steps``), the workers
(``train.single_frame``, ``train.multi_frame``) and the tools of the staged
pipeline (``tools.presave_flow``, ``tools.presave_disp``,
``tools.build_cache``), which read and write the datasets' HDF5 files with
``data.hdf5`` (numpy alone); and the learned flow provider
(``models.flownet.FlowNet``, trained by ``tools.train_flow``), which
gives the track server, ``presave_flow --provider learned`` and
``--flow_source net`` their flow. Their hot kernels (census-SAD, the pattern warp by
disparity, the flow warp and the pair-indexed flow warp of FuseNet, forward
and backward) are hand-written CUDA C++ for Hopper under ``csrc/``. On a
CUDA tensor each runs its kernel or raises; on a CPU tensor it runs its
plain PyTorch version, which the tests compare with the JAX package.

The package imports torch and numpy only: never jax, flax, h5py, cv2 or the
JAX package itself.
"""

__version__ = "0.1.0"
