"""Spans that the benchmark records around its calls into the program's
layers, for the traced window: ``record_function`` ranges, which the
profiler keeps as ``user_annotation`` events on the calling thread. Each is
installed for the window only and taken away after it; the program's code
is not edited."""

from __future__ import annotations

import contextlib
import functools

from torch.autograd.profiler import record_function


def wrap(fn, name: str):
    """``fn`` inside a span called ``name``."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return inner


@contextlib.contextmanager
def around(owner, attr: str, name: str):
    """``owner.attr`` (a module's function or an object's method) inside a
    span called ``name`` while the block runs."""
    own = attr in vars(owner)
    original = getattr(owner, attr)
    setattr(owner, attr, wrap(original, name))
    try:
        yield
    finally:
        if own:
            setattr(owner, attr, original)
        else:
            delattr(owner, attr)


@contextlib.contextmanager
def forward_of(module, name: str):
    """Every forward of ``module`` inside a span called ``name``."""
    open_spans = []

    def enter(mod, args):
        span = record_function(name)
        span.__enter__()
        open_spans.append(span)

    def leave(mod, args, out):
        open_spans.pop().__exit__(None, None, None)

    hooks = [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
