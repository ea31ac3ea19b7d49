"""Command-line tools of the staged pipeline, ports of
``depthinspace_tpu/tools/``: ``presave_flow`` (the rigid, farneback and
learned providers), ``presave_disp`` (the DIS-SF and DIS-MF hand-off
files), ``build_cache`` (the wire cache), ``train_flow`` (FlowNet's
trainer), ``make_fixture`` (a plane-scene dataset), ``create_syn_data``
(the rendered synthetic dataset, on the host), and ``pipeline_drive``
(the whole pipeline in one process, the port of
``scripts/pipeline_drive.py``). Each reads and writes the datasets' HDF5
files with ``data/hdf5.py``."""
