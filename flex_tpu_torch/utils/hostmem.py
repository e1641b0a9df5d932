"""Host allocator tuning for large NumPy temporaries.

Copy of ``flex_tpu.utils.hostmem``.  glibc's default M_MMAP_THRESHOLD
serves every allocation of 128 KB or more with mmap and returns it with
munmap on free, so every large temporary of an O(nnz) host pass (the
window selection, the orderings, the CSV parse) faults its pages in
again.  Keeping large buffers on the heap (mmap and trim disabled) pays
the faults once and reuses the pages after that.
"""
from __future__ import annotations

import ctypes
import os

_done = False

# glibc mallopt parameter numbers (glibc malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4


def tune_host_malloc() -> bool:
    """Disable glibc's mmap-and-return path for large allocations.

    Idempotent; does nothing and returns False on a platform without glibc
    or when ``FLEX_TPU_NO_MALLOC_TUNE`` is set.  Safe to call after
    start-up: mallopt adjusts the thresholds for later allocations."""
    global _done
    if _done:
        return True
    if os.environ.get("FLEX_TPU_NO_MALLOC_TUNE"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(2**31 - 1)))
        ok = bool(libc.mallopt(_M_MMAP_MAX, 0)) and ok
    except OSError:
        return False
    _done = ok
    return ok
