"""Shape-only tracing of the kernel wrappers (the multi-device dry run,
``launch/dryrun.py``).

A kernel has no meta-device form: a wrapper handed a meta tensor raises,
as it does for any device but the CPU and CUDA. Inside
:func:`plain_on_meta` it runs its plain torch version on the meta tensors
instead, by name, and counts the call in :data:`TRACED`, so a trace says
which kernels the path it traced stands for and how often each would
launch. Outside the context nothing changes.
"""
from __future__ import annotations

import contextlib
from typing import Dict

#: plain calls made for each kernel wrapper inside :func:`plain_on_meta`
TRACED: Dict[str, int] = {}
_STATE = {"on": False}


@contextlib.contextmanager
def plain_on_meta():
    """While inside, a kernel wrapper given meta tensors runs its plain
    version, counted in :data:`TRACED` (reset on entry). Not thread-local:
    a remat recompute may run on the autograd engine's thread."""
    old = _STATE["on"]
    _STATE["on"] = True
    TRACED.clear()
    try:
        yield TRACED
    finally:
        _STATE["on"] = old


def meta_plain(name: str, q) -> bool:
    """True when ``q`` is a meta tensor inside :func:`plain_on_meta` (the
    wrapper ``name`` then runs its plain version; counted); False for any
    other device; a meta tensor outside the context raises."""
    if q.device.type != "meta":
        return False
    if not _STATE["on"]:
        raise RuntimeError(
            f"{name}: the kernels run on CUDA or CPU tensors, not meta "
            "ones; a meta tensor runs the plain version only inside "
            "kernels.trace.plain_on_meta()")
    TRACED[name] = TRACED.get(name, 0) + 1
    return True
