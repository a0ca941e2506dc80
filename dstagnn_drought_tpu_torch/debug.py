"""Debug mode: a sanitizer for the train step — counterpart of the JAX
package's ``checkify`` step (``training/step.py:make_checked_train_step``).

Inside :func:`checking` every floating output of every aten op (forward,
backward and the optimizer update) is checked on the host, and the first
op that emits a non-finite value raises :class:`NonFiniteError`, naming
the op, the train batch and, for a forward op, the source line. A NaN
always counts; an inf only where the op's floating inputs were finite (a
``-inf`` fill constant or a value an earlier op let through is not
emitted there). The CUDA kernels write through raw pointers, where no
dispatch mode sees them: each kernel's launch function is wrapped in
:func:`kernel` with the kernel's name, which checks its floating outputs
and lets the aten ops inside the launch (its buffers, its plain version on
the CPU) go unchecked, so a kernel that emits a NaN is named, not the next
op that reads it. Every check synchronises with the device: a debugging
mode, as in JAX. :func:`check_batch_indices` checks a batch's index vector
against its split's length on the host, before the gather.
"""
from __future__ import annotations

import contextlib
import functools
import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class NonFiniteError(FloatingPointError):
    """A NaN or inf emitted under :func:`checking`."""


class BatchIndexError(IndexError):
    """A batch index outside its split, found before the gather."""


# the checker of the innermost open ``checking`` region, and how deep the
# kernel launches in progress are nested (their own ops go unchecked)
_active: list["_CheckMode"] = []
_kernel_depth = 0

# ops whose output is uninitialised memory: nothing to check; nor the
# collectives (namespace c10d), whose outputs are written when their work
# completes, after the op returns: the next op that reads them checks them
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "resize_", "empty_permuted"}
_PACKAGE = os.path.dirname(os.path.abspath(__file__))


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def _floating(obj):
    return [t for t in _tensors(obj) if t.is_floating_point() and t.numel()]


def _kind(ts) -> str | None:
    """'nan', 'inf' or None for the floating tensors ``ts``."""
    bad = [t for t in ts if not bool(torch.isfinite(t).all())]
    if not bad:
        return None
    return "nan" if any(bool(torch.isnan(t).any()) for t in bad) else "inf"


def _scalars_finite(args) -> bool:
    for a in args:
        if isinstance(a, float) and not (a == a and abs(a) != float("inf")):
            return False
        if isinstance(a, (list, tuple)) and not _scalars_finite(a):
            return False
    return True


def _source_line() -> str | None:
    """The innermost frame of this package outside this module, as
    ``file:line in function``."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.startswith(_PACKAGE) and frame.filename != __file__:
            rel = os.path.relpath(frame.filename, os.path.dirname(_PACKAGE))
            return f"{rel}:{frame.lineno} in {frame.name}"
    return None


class _CheckMode(TorchDispatchMode):
    def __init__(self, batch):
        super().__init__()
        self.batch = batch

    def fail(self, kind: str, what: str, where: str | None = None):
        node = torch._C._current_autograd_node()
        if node is not None:
            what += f" in the backward of {node.name()}"
        elif where is None:
            where = _source_line()
        raise NonFiniteError(f"{kind} emitted by {what} at batch {self.batch}"
                             + (f" ({where})" if where else ""))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (_kernel_depth or func.is_view or func.__name__.split(".")[0] in _UNINITIALISED
                or func.namespace == "c10d"):
            return out
        schema = func._schema.arguments
        written = [a for a, s in zip(args, schema)
                   if s.alias_info is not None and s.alias_info.is_write]
        written += [kwargs[s.name] for s in schema if s.name in kwargs
                    and s.alias_info is not None and s.alias_info.is_write]
        kind = _kind(_floating(out) + _floating(written))
        if kind == "inf" and not (_kind(_floating(args) + _floating(list(kwargs.values())))
                                  is None and _scalars_finite(args)
                                  and _scalars_finite(list(kwargs.values()))):
            kind = None  # carried in, not emitted here
        if kind is not None:
            self.fail(kind, f"aten.{func.__name__}")
        return out


@contextlib.contextmanager
def checking(batch=None):
    """Check every op and kernel launched inside for NaN/inf (see the
    module docstring); ``batch`` is named in the error."""
    mode = _CheckMode(batch)
    _active.append(mode)
    try:
        with mode:
            yield mode
    finally:
        _active.remove(mode)


def kernel(name: str):
    """Decorator for a kernel's launch function (and its plain version):
    under :func:`checking` its floating outputs are checked under the
    kernel's ``name``, and the aten ops it runs inside are not."""
    def wrap(fn):
        @functools.wraps(fn)
        def launch(*args, **kwargs):
            global _kernel_depth
            if not _active:
                return fn(*args, **kwargs)
            _kernel_depth += 1
            kind = None
            try:
                out = fn(*args, **kwargs)
                if _kernel_depth == 1:  # the check's own ops go unchecked too
                    kind = _kind(_floating(out))
            finally:
                _kernel_depth -= 1
            if kind is not None:
                _active[-1].fail(kind, f"the {name} kernel", f"{fn.__module__}.{fn.__name__}")
            return out
        launch.kernel_name = name
        return launch
    return wrap


def check_batch_indices(idx, n: int, batch=None) -> None:
    """Raise :class:`BatchIndexError` where an index of ``idx`` (numpy or a
    CPU tensor) is outside [0, n): checked on the host, before the gather
    (an out-of-range gather on the card is a device-side assert that ruins
    the CUDA context)."""
    idx = torch.as_tensor(idx)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise BatchIndexError(
            f"batch index out of range at batch {batch}: indices in "
            f"[{int(idx.min())}, {int(idx.max())}] for a split of {n} samples "
            "(checked before the gather)")
