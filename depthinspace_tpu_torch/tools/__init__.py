"""Command-line tools of the staged pipeline, ports of
``depthinspace_tpu/tools/``: ``presave_flow`` (the rigid provider),
``presave_disp`` (the DIS-SF and DIS-MF hand-off files) and ``build_cache``
(the wire cache). Each reads and writes the datasets' HDF5 files with
``data/hdf5.py``."""
