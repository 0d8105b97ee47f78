"""Training dataset: file lists -> uint8 batches, and the host prefetch thread.

The port's own copy of the host half of ``building_detection_tpu/data/
dataset.py`` (the reference's generators, `train_model/res34.py:57-157`):
sorted image/label pairing, infinite cycling, fixed batch size.  Decoding
yields raw uint8; normalisation, one-hot and the edge-weight maps happen on
the step's device inside the train step
(:func:`building_detection_tpu_torch.train.trainer.make_targets`), so the
host feeder only reads files.  The device upload thread is
:func:`building_detection_tpu_torch.data.prefetch.device_prefetch`.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
from typing import Iterator, Sequence, Tuple

import numpy as np


def list_pairs(img_dir: str, lab_dir: str, exts=(".png", ".jpg", ".tif", ".tiff")):
    """Sorted (image, label) path pairs; counts must match
    (`res34.py:25-33` asserts equality)."""
    imgs = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir) if f.lower().endswith(exts))
    labs = sorted(os.path.join(lab_dir, f) for f in os.listdir(lab_dir) if f.lower().endswith(exts))
    if len(imgs) != len(labs):
        raise ValueError(f"image/label count mismatch: {len(imgs)} vs {len(labs)}")
    return list(zip(imgs, labs))


def decode_pair(img_path: str, lab_path: str, image_size: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 (H,W,3) RGB + (H,W) gray, resized to ``image_size``
    (`res34.py:36-54`; values stay uint8, device code normalises)."""
    from PIL import Image

    with Image.open(img_path) as im:
        img = np.asarray(im.convert("RGB").resize((image_size, image_size), Image.BILINEAR))
    with Image.open(lab_path) as im:
        lab = np.asarray(im.convert("L").resize((image_size, image_size), Image.BILINEAR))
    return img, lab


def batch_iterator(
    pairs: Sequence[Tuple[str, str]],
    batch_size: int = 8,
    image_size: int = 512,
    shuffle: bool = False,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite (images, labels) uint8 batches; by default cycles in sorted
    order (`res34.py:57-111` uses ``itertools.cycle`` over the sorted lists).
    ``shuffle=True`` (opt-in; the reference never shuffles) draws a fresh
    seeded permutation of the pair list each pass.  Augmentation happens in
    the train step (``Trainer(augment=...)``), not here."""
    if shuffle:
        def ordered():
            n_pass = 0
            while True:
                order = np.random.RandomState(seed + n_pass).permutation(len(pairs))
                n_pass += 1
                for i in order:
                    yield pairs[i]

        cycled = ordered()
    else:
        cycled = itertools.cycle(pairs)
    while True:
        imgs, labs = [], []
        for _ in range(batch_size):
            ip, lp = next(cycled)
            img, lab = decode_pair(ip, lp, image_size)
            imgs.append(img)
            labs.append(lab)
        yield np.stack(imgs), np.stack(labs)


def _threaded_pipe(iterator: Iterator, prepare, depth: int, name: str) -> Iterator:
    """Background-thread pipeline: ``prepare(item)`` runs ``depth`` items
    ahead of the consumer.

    An exception in the feeder surfaces at the consumer's ``next()`` rather
    than ending the iteration silently; a consumer that stops early (a fit
    that finished its epochs over an infinite iterator, or raised) releases
    the worker: closing the generator sets ``done`` and joins the worker,
    which never blocks on a full queue for longer than 0.2 s.  The join
    matters at exit: a daemon worker still inside a torch op that released
    the interpreter lock when the interpreter finalizes is ended by
    ``pthread_exit`` inside a ``noexcept`` frame, and the process aborts
    ("terminate called without an active exception").
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    done = threading.Event()
    err: list = []

    def offer(x) -> bool:
        while not done.is_set():
            try:
                q.put(x, timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not offer(prepare(item)):
                    return
        except BaseException as e:  # re-raised at the consumer's next()
            err.append(e)
        finally:
            offer(stop)

    thread = threading.Thread(target=worker, daemon=True, name=name)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        done.set()
        thread.join()


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch so file decoding overlaps the device step
    (the reference's feeder decodes one batch between steps,
    `res34.py:673-678`)."""
    return _threaded_pipe(iterator, lambda x: x, depth, "bdt-prefetch")
