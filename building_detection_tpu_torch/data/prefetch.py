"""Host-to-device upload pipelining for the streamed training path.

The counterpart of ``building_detection_tpu/data/dataset.py::device_prefetch``,
which reaches JAX through ``parallel.mesh`` and so cannot be imported where
the port runs.  A background thread (:func:`data.dataset._threaded_pipe`)
copies each ``(images, labels)`` host batch into
pinned memory and uploads it on a side CUDA stream, ``depth`` batches
ahead, so batch N+1's transfer overlaps batch N's step.  The consumer's
stream waits on each upload's event before the tensors are used, and the
tensors are recorded on that stream so the allocator does not reuse them
early.  On the CPU the batches pass through as tensors.

Under data parallelism (a ``mesh`` with ``data > 1``) each rank uploads only
its rows: the iterator yields the global batch and the rank's rows are
taken before the copy, or, with ``from_process_local=True``, it already
yields only those rows (each rank decodes ``1/data`` of the stream, the JAX
package's process-local feeding).
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from building_detection_tpu_torch.data.dataset import _threaded_pipe
from building_detection_tpu_torch.parallel import mesh as pmesh

Batch = Tuple[torch.Tensor, torch.Tensor]


def device_prefetch(
    iterator: Iterator,
    device: Union[str, torch.device],
    depth: int = 2,
    mesh: Optional[pmesh.Mesh] = None,
    from_process_local: bool = False,
) -> Iterator[Batch]:
    """Yield each ``(images, labels)`` of ``iterator`` as tensors on
    ``device``: this rank's rows of each global batch under a ``mesh``
    (already cut when ``from_process_local``)."""
    device = torch.device(device)
    if mesh is not None and mesh.data > 1 and not from_process_local:
        iterator = (pmesh.shard_batch(item, mesh) for item in iterator)
    if device.type != "cuda":
        yield from _threaded_pipe(
            iterator, lambda item: tuple(torch.as_tensor(np.asarray(a)).to(device) for a in item),
            depth, "bdt-torch-prefetch",
        )
        return
    side = torch.cuda.Stream(device)

    def upload(item):
        out = []
        with torch.cuda.stream(side):
            for a in item:
                host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                out.append(host.to(device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    for tensors, done in _threaded_pipe(iterator, upload, depth, "bdt-torch-prefetch"):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in tensors:
            t.record_stream(consumer)
        yield tuple(tensors)
