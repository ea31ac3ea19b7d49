"""Command-line tools of the staged pipeline, ports of
``depthinspace_tpu/tools/``: ``presave_flow`` (the rigid and learned
providers), ``presave_disp`` (the DIS-SF and DIS-MF hand-off files),
``build_cache`` (the wire cache), ``train_flow`` (FlowNet's trainer) and
``make_fixture`` (a plane-scene dataset). Each reads and writes the
datasets' HDF5 files with ``data/hdf5.py``."""
