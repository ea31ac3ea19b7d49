"""Dataset settings (settings.pkl), port of
``depthinspace_tpu/data/settings.py`` without cv2: a pickle of
{'imsize': (H, W), 'pattern': (H, W, 3) float image, 'baseline': float,
'K': (3, 3) intrinsics} at DATA_DIR/settings.pkl. (``pattern_at_scale``,
which resizes the pattern with cv2, is not ported.)
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class Settings:
    imsize: tuple
    pattern: np.ndarray          # (H, W, 3) float32 in [0, 1]
    baseline: float
    K: np.ndarray                # (3, 3) float32

    @property
    def focal_length(self) -> float:
        return float(self.K[0, 0])

    def K_at_scale(self, sidx: int) -> np.ndarray:
        """Intrinsics of the sidx-th pyramid level."""
        K = self.K.copy() / (2 ** sidx)
        K[2, 2] = 1
        return K

    def pattern_gray(self) -> np.ndarray:
        """Channel-mean single-channel pattern."""
        return self.pattern.mean(axis=2).astype(np.float32)


def load_settings(path) -> Settings:
    with open(str(path), "rb") as f:
        d = pickle.load(f)
    return Settings(imsize=tuple(d["imsize"]),
                    pattern=np.asarray(d["pattern"], np.float32),
                    baseline=float(d["baseline"]),
                    K=np.asarray(d["K"], np.float32))


def save_settings(path, s: Settings) -> None:
    d = {"imsize": tuple(s.imsize), "pattern": np.asarray(s.pattern, np.float32),
         "baseline": float(s.baseline), "K": np.asarray(s.K, np.float32)}
    with open(str(path), "wb") as f:
        pickle.dump(d, f, pickle.HIGHEST_PROTOCOL)
