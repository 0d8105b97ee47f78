"""Data augmentation: on-device training transforms and the offline dataset builder.

The counterpart of ``building_detection_tpu/data/augment.py::augment_batch``
(the reference's ``Data_Enhance`` menu, applied in place per sample):

* p=0.8 flip up-down, p=0.8 flip left-right;
* p=0.8 scale by 0.6-2.0x about the centre as one bilinear resample of the
  source grid, gray-128 padding where the source runs out, the label
  re-binarised at 125;
* p=0.3 channel swap (RGB <-> BGR).

:func:`apply_augment` does the work from explicit per-sample decisions;
:func:`draw_decisions` draws them from a CPU ``torch.Generator`` seeded from
``(augment_seed, step)``, so a step's batch is the same on every device and
on the staged and per-step paths.  torch cannot reproduce JAX's threefry
bits, so the tests hand both packages the same decisions.

:class:`DatasetBuilder` is the port's copy of the JAX package's offline,
file-in / file-out builder (`data_enhancement.py:39-203`): augmented copies
and the 9:1 split written to disk, its draws from
``np.random.RandomState(seed)`` in the same order, so one seed writes the
same files, byte for byte, in both packages.
"""
from __future__ import annotations

import os
import shutil
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from building_detection_tpu_torch.core.config import AugmentConfig
from building_detection_tpu_torch.utils import io as uio


class Decisions(NamedTuple):
    """Per-sample choices, each ``(N,)``: booleans and f32 ``scales``."""

    do_ud: torch.Tensor
    do_lr: torch.Tensor
    do_sc: torch.Tensor
    scales: torch.Tensor
    do_col: torch.Tensor


def draw_decisions(n: int, augment_seed: int, step: int, cfg: AugmentConfig = AugmentConfig()) -> Decisions:
    """The decisions of global step ``step``, on the CPU."""
    seed = int(np.random.SeedSequence([augment_seed, step]).generate_state(1, np.uint64)[0])
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((5, n), generator=gen)
    lo, hi = cfg.scale_range
    return Decisions(
        do_ud=u[0] < cfg.p_flip_ud,
        do_lr=u[1] < cfg.p_flip_lr,
        do_sc=u[2] < cfg.p_scale,
        scales=lo + u[3] * (hi - lo),
        do_col=u[4] < cfg.p_color,
    )


def _scale(images: torch.Tensor, labels: torch.Tensor, scales: torch.Tensor, cfg: AugmentConfig):
    """Every sample scaled by its own factor about the centre: one bilinear
    resample of the source grid, rounded; gray ``pad_value`` (image) and 0
    (label) outside the source; the label re-binarised at
    ``label_threshold``.  The f32 arithmetic is the JAX version's, in its
    order, so the bytes agree."""
    n, h, w = labels.shape
    dev = images.device
    s = scales.to(device=dev, dtype=torch.float32)[:, None]
    yy = (torch.arange(h, device=dev, dtype=torch.float32) - (h - 1) / 2.0) / s + (h - 1) / 2.0
    xx = (torch.arange(w, device=dev, dtype=torch.float32) - (w - 1) / 2.0) / s + (w - 1) / 2.0
    y0, x0 = torch.floor(yy), torch.floor(xx)
    fy, fx = yy - y0, xx - x0
    y0c, y1c = y0.long().clamp(0, h - 1), (y0.long() + 1).clamp(0, h - 1)
    x0c, x1c = x0.long().clamp(0, w - 1), (x0.long() + 1).clamp(0, w - 1)
    b = torch.arange(n, device=dev)[:, None, None]

    def bilinear(src: torch.Tensor) -> torch.Tensor:
        f = src.float()
        a, bb = f[b, y0c[:, :, None], x0c[:, None, :]], f[b, y0c[:, :, None], x1c[:, None, :]]
        c, d = f[b, y1c[:, :, None], x0c[:, None, :]], f[b, y1c[:, :, None], x1c[:, None, :]]
        extra = (None,) * (src.dim() - 3)
        wy = fy[(slice(None), slice(None), None) + extra]
        wx = fx[(slice(None), None, slice(None)) + extra]
        top = a * (1 - wx) + bb * wx
        bot = c * (1 - wx) + d * wx
        return torch.round(top * (1 - wy) + bot * wy)

    inside = (
        ((yy >= 0) & (yy <= h - 1))[:, :, None] & ((xx >= 0) & (xx <= w - 1))[:, None, :]
    )
    out_img = torch.where(inside[..., None], bilinear(images).to(torch.uint8), cfg.pad_value)
    out_lab = torch.where(inside, bilinear(labels).to(torch.uint8), 0)
    out_lab = torch.where(out_lab > cfg.label_threshold, 255, 0).to(torch.uint8)
    return out_img.to(torch.uint8), out_lab


def apply_augment(
    images: torch.Tensor,
    labels: torch.Tensor,
    decisions: Decisions,
    cfg: AugmentConfig = AugmentConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(N,H,W,3)`` u8, ``(N,H,W)`` u8 -> augmented, same shapes, on the
    inputs' device: flips, then the scale, then the channel swap."""
    dev = images.device
    ud, lr, sc, col = (t.to(dev) for t in (decisions.do_ud, decisions.do_lr, decisions.do_sc, decisions.do_col))
    images = torch.where(ud[:, None, None, None], images.flip(1), images)
    labels = torch.where(ud[:, None, None], labels.flip(1), labels)
    images = torch.where(lr[:, None, None, None], images.flip(2), images)
    labels = torch.where(lr[:, None, None], labels.flip(2), labels)
    s_img, s_lab = _scale(images, labels, decisions.scales, cfg)
    images = torch.where(sc[:, None, None, None], s_img, images)
    labels = torch.where(sc[:, None, None], s_lab, labels)
    images = torch.where(col[:, None, None, None], images.flip(3), images)
    return images, labels


def augment_batch(
    images: torch.Tensor,
    labels: torch.Tensor,
    augment_seed: int,
    step: int,
    cfg: AugmentConfig = AugmentConfig(),
    shard: Tuple[int, int] = (0, 1),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch of global step ``step`` under ``augment_seed``.

    ``shard=(rank, data)``: the batch is rank ``rank``'s rows of a global
    batch split in ``data`` equal parts.  The decisions are drawn for the
    global batch and the rank's rows taken, so each rank augments its rows
    as one process augments the whole batch."""
    rank, data = shard
    n = images.shape[0]
    decisions = draw_decisions(n * data, augment_seed, step, cfg)
    if data > 1:
        decisions = Decisions(*(t[rank * n : (rank + 1) * n] for t in decisions))
    return apply_augment(images, labels, decisions, cfg)


# ---------------------------------------------------------------------------
# Offline dataset builder (reference-faithful, file in / file out)
# ---------------------------------------------------------------------------
class DatasetBuilder:
    """``Data_Enhance``: write augmented copies and split 9:1.

    Unlike the reference, paths are constructor arguments, augmentation is
    seedable, and the train/val split writes to four distinct directories
    (the reference's split writes train and val to the same folders,
    `data_enhancement.py:167-170`).  Per image, with the reference's
    probabilities (`data_enhancement.py:73-98`): the original; p=0.8 flip
    up-down (``_1``); p=0.8 flip left-right (``_2``); p=0.8 random scale
    0.6-2.0x with gray padding or centre crop and a nested random flip
    (``_3``); p=0.3 channel swap (``_4``).
    """

    def __init__(
        self,
        read_img_path: str,
        read_lab_path: str,
        save_img_path: str,
        save_lab_path: str,
        cfg: AugmentConfig = AugmentConfig(),
        seed: Optional[int] = None,
    ):
        for p in (read_img_path, read_lab_path):
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        self.read_img_path = read_img_path
        self.read_lab_path = read_lab_path
        self.save_img_path = save_img_path
        self.save_lab_path = save_lab_path
        os.makedirs(save_img_path, exist_ok=True)
        os.makedirs(save_lab_path, exist_ok=True)
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)

    def _save(self, img: np.ndarray, lab: np.ndarray, stem: str) -> None:
        uio.imwrite(os.path.join(self.save_img_path, stem + ".png"), img.astype(np.uint8))
        uio.imwrite(os.path.join(self.save_lab_path, stem + ".png"), lab.astype(np.uint8))

    def _random_scale(self, img: np.ndarray, lab: np.ndarray, scale: float):
        """`data_enhancement.py:102-131` with the (w, h) resize-argument swap
        fixed (a no-op on the square 512 tiles the reference processes)."""
        from PIL import Image

        h, w = img.shape[:2]
        nh, nw = int(h * scale), int(w * scale)
        image = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        label = np.asarray(Image.fromarray(lab).resize((nw, nh), Image.BILINEAR))
        label = np.where(label > self.cfg.label_threshold, 255, 0).astype(np.uint8)
        if scale < 1:
            x, y = (w - nw) // 2, (h - nh) // 2
            new_img = np.full((h, w, 3), self.cfg.pad_value, np.uint8)
            new_lab = np.zeros_like(lab)
            new_img[y : y + nh, x : x + nw] = image
            new_lab[y : y + nh, x : x + nw] = label
        else:
            x = max((nw - w) // 2 - 1, 0)
            y = max((nh - h) // 2 - 1, 0)
            new_img = image[y : y + h, x : x + w]
            new_lab = label[y : y + h, x : x + w]
        r = self.rng.rand()
        if 0.7 > r >= 0.4:
            new_img, new_lab = new_img[::-1], new_lab[::-1]
        elif r >= 0.7:
            new_img, new_lab = new_img[:, ::-1], new_lab[:, ::-1]
        return new_img, new_lab

    def _draw_scale(self) -> float:
        lo, hi = self.cfg.scale_range
        return self.rng.randint(int(lo * 10), int(hi * 10) + 1) / 10

    def run(self) -> int:
        """Augment every image; returns the number of pairs written
        (`data_enhancement.py:62-100`)."""
        cfg = self.cfg
        written = 0
        for name in sorted(os.listdir(self.read_img_path)):
            stem = name.rsplit(".", 1)[0]
            img = uio.imread_rgb(os.path.join(self.read_img_path, name))
            lab = uio.imread_gray(os.path.join(self.read_lab_path, name))
            self._save(img, lab, stem)
            written += 1
            if self.rng.rand() < cfg.p_flip_ud:
                self._save(img[::-1], lab[::-1], stem + "_1")
                written += 1
            if self.rng.rand() < cfg.p_flip_lr:
                self._save(img[:, ::-1], lab[:, ::-1], stem + "_2")
                written += 1
            if self.rng.rand() < cfg.p_scale:
                im3, lb3 = self._random_scale(img, lab, self._draw_scale())
                self._save(im3, lb3, stem + "_3")
                written += 1
            if self.rng.rand() < cfg.p_color:
                self._save(img[..., ::-1], lab, stem + "_4")
                written += 1
        return written

    def run_copy_paste(
        self,
        donor_range: Tuple[float, float] = (0.075, 0.20),
        max_samples: Optional[int] = None,
    ) -> int:
        """Instance transplant, the step the reference describes but never
        implements (`data_enhancement.py:17-21`): images with building
        coverage in (7.5 %, 20 %] are donors, those at or below 7.5 %
        recipients; each recipient gets a random donor, both are randomly
        scaled (``_random_scale``), and the donor's building pixels (image
        and label) are copied in.  Writes ``{stem}_5`` files; returns how
        many."""
        lo_cov, hi_cov = donor_range
        entries = []  # (name, coverage)
        for name in sorted(os.listdir(self.read_img_path)):
            lab = uio.imread_gray(os.path.join(self.read_lab_path, name))
            entries.append((name, float(np.mean(lab > 0))))
        donors = [n for n, cov in entries if lo_cov < cov <= hi_cov]
        recipients = [n for n, cov in entries if cov <= lo_cov]
        if not donors or not recipients:
            return 0
        written = 0
        for name in recipients:
            if max_samples is not None and written >= max_samples:
                break
            donor = donors[self.rng.randint(len(donors))]
            d_img = uio.imread_rgb(os.path.join(self.read_img_path, donor))
            d_lab = uio.imread_gray(os.path.join(self.read_lab_path, donor))
            r_img = uio.imread_rgb(os.path.join(self.read_img_path, name))
            r_lab = uio.imread_gray(os.path.join(self.read_lab_path, name))
            if d_img.shape != r_img.shape:
                continue  # a transplant needs matching canvases
            d_img, d_lab = self._random_scale(d_img, d_lab, self._draw_scale())
            r_img, r_lab = self._random_scale(r_img, r_lab, self._draw_scale())
            mask = d_lab > 0
            out_img = r_img.copy()
            out_img[mask] = d_img[mask]
            out_lab = np.where(mask, np.uint8(255), r_lab)
            self._save(out_img, out_lab, name.rsplit(".", 1)[0] + "_5")
            written += 1
        return written

    def split_train_val(
        self,
        train_img: str,
        train_lab: str,
        val_img: str,
        val_lab: str,
        split_rate: Optional[float] = None,
    ) -> Tuple[int, int]:
        """Sequential 9:1 split by file name (`data_enhancement.py:153-203`)."""
        rate = split_rate if split_rate is not None else self.cfg.split_rate
        imgs = sorted(os.listdir(self.save_img_path))
        labs = sorted(os.listdir(self.save_lab_path))
        if len(imgs) != len(labs):
            raise ValueError("image/label counts differ")
        for a, b in zip(imgs, labs):
            if a != b:
                raise ValueError(f"name mismatch: {a} vs {b}")
        for d in (train_img, train_lab, val_img, val_lab):
            os.makedirs(d, exist_ok=True)
        split = int(len(imgs) * rate)
        for name in imgs[:split]:
            shutil.copy(os.path.join(self.save_img_path, name), train_img)
            shutil.copy(os.path.join(self.save_lab_path, name), train_lab)
        for name in imgs[split:]:
            shutil.copy(os.path.join(self.save_img_path, name), val_img)
            shutil.copy(os.path.join(self.save_lab_path, name), val_lab)
        return split, len(imgs) - split
