"""Host helpers of the streamed path's uploads.

The pool and row-chunk helpers are copied verbatim from
``distance_tpu/ops/diffup.py``, where the streamed path's transpose
(``engine._transpose_add``) imports them; ``tests/test_torch_host_copies.py``
pins them to their originals.  The diff-encoded upload of that module is
not ported yet.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


def _get_pool() -> ThreadPoolExecutor:
    from distance_tpu_torch.finalize import _get_pool as shared

    return shared()


def _row_chunks(n_rows: int, workers: int):
    per = max(256, -(-n_rows // (workers * 2)))
    return [(r0, min(n_rows, r0 + per)) for r0 in range(0, n_rows, per)]
