"""Per-frame host augmentation with disparity correction, port of
``depthinspace_tpu/data/augment.py`` in numpy (``data/imgproc.py`` in place
of cv2): an optional shear/shift along x whose horizontal displacement is
added to every disparity map (a horizontal image shift is a disparity
offset), a 5x5 Gaussian blur (p = 0.5), per-pixel Gaussian noise, salt and
pepper noise (p = 0.5) and a clip to [0, 1]. It makes the JAX function's
``np.random.RandomState`` draws in the same order, so one seed gives the
same augmentation in both packages. The training defaults turn the shear
off (``TrackDataset.max_shift = 0``).
"""

from __future__ import annotations

import numpy as np

from .imgproc import gaussian_blur5, warp_affine


def augment_frame(img: np.ndarray, rng: np.random.RandomState,
                  amb: np.ndarray | None = None,
                  disp: np.ndarray | None = None,
                  primary_disp: np.ndarray | None = None,
                  sgm_disp: np.ndarray | None = None,
                  grad: np.ndarray | None = None,
                  max_shift: float = 64.0, max_blur: float = 1.5,
                  max_noise: float = 10.0, max_sp_noise: float = 0.001):
    """Augment one (H, W) frame and its aligned maps. Returns the augmented
    (img, amb, disp, primary_disp, sgm_disp, grad); a map given as None
    comes back as None. The images come back float64 after the noise, the
    shifted disparity maps float64 (as from cv2), the others as given."""
    min_val = float(np.min(img))
    max_val = float(np.max(img))

    out_img, out_amb, out_grad = img, amb, grad
    out_disp, out_pdisp, out_sgm = disp, primary_disp, sgm_disp

    if max_shift > 1:
        rows, cols = img.shape
        shear, shift = 0.0, 0.0
        if rng.uniform(0, 1) < 0.75:
            shear = rng.uniform(-max_shift, max_shift)
        else:
            shift = rng.uniform(-max_shift / 2, max_shift)
        shear_correction = -shear if shear < 0 else 0.0
        a = shear / float(rows)
        b = shift + shear_correction
        T = np.float32([[1, a, b], [0, 1, 0]])
        out_img = warp_affine(out_img, T)
        if amb is not None:
            out_amb = warp_affine(out_amb, T)
        if grad is not None:
            out_grad = warp_affine(grad, T)
        # the horizontal displacement of each row is its disparity offset
        disp_delta = np.tile(a * np.arange(rows) + b, (cols, 1)).T
        if disp is not None:
            out_disp = warp_affine(disp + disp_delta, T)
        if primary_disp is not None:
            out_pdisp = warp_affine(primary_disp + disp_delta, T)
        if sgm_disp is not None:
            out_sgm = warp_affine(sgm_disp + disp_delta, T)

    if rng.uniform(0, 1) < 0.5:
        sigma = rng.uniform(0.2, max_blur)
        out_img = gaussian_blur5(out_img, sigma)
        if amb is not None:
            out_amb = gaussian_blur5(out_amb, rng.uniform(0.2, max_blur))

    out_img = out_img + rng.randn(*out_img.shape) * rng.uniform(
        0.0, max_noise) / 255.0
    if amb is not None:
        out_amb = out_amb + rng.randn(*out_amb.shape) * rng.uniform(
            0.0, max_noise) / 255.0

    if rng.uniform(0, 1) < 0.5:
        ratio = rng.uniform(0.0, max_sp_noise)
        shape = out_img.shape
        flat = out_img.flatten()
        coord = rng.choice(flat.size, int(flat.size * ratio))
        flat[coord] = max_val
        coord = rng.choice(flat.size, int(flat.size * ratio))
        flat[coord] = min_val
        out_img = flat.reshape(shape)

    out_img = np.clip(out_img, 0.0, 1.0)
    if amb is not None:
        out_amb = np.clip(out_amb, 0.0, 1.0)

    return out_img, out_amb, out_disp, out_pdisp, out_sgm, out_grad
