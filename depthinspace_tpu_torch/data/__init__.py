"""The data layer. Its names are imported from their modules at first use
(PEP 562), so a host tool that needs only numpy modules of this package
(``tools/create_syn_data.py``: ``hdf5``, ``patterns``, ``settings``,
``synthetic``) does not import torch."""

import importlib

_EXPORTS = {
    "augment": ("augment_frame",),
    "batch": ("Batch", "batch_to_torch"),
    "cache": ("BASE_FIELDS", "CACHE_DIR_NAME", "CachedTrackDataset",
              "build_wire_cache", "has_wire_cache"),
    "dataset": ("DataLoader", "MultiDataset", "SyntheticSource",
                "SyntheticTrackDataset", "TrackDataset", "collate"),
    "fixture": ("generate_dataset",),
    "settings": ("Settings", "load_settings", "save_settings"),
    "synthetic": ("make_settings", "make_dot_pattern", "make_track_batch",
                  "rigid_flow", "smooth_disparity"),
    "wire": ("decode_batch", "decode_batch_np", "decode_disp_np",
             "encode_batch"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_MODULE_OF[name]}", __name__),
                    name)
    globals()[name] = value
    return value
