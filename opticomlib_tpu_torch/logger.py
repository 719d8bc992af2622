"""Hierarchical indented debug logging (copied from
``opticomlib_tpu.logger``; no JAX there either).

Fresh implementation of the reference's ``HierLogger``
(reference opticomlib/logger.py:10-173): a ``logging`` wrapper with
thread-local indentation state so nested instrumented calls print as an
indented tree::

    /> DAC
    |   /> upfir
    |   |   /> fft_convolve

``auto_indent`` wraps a single callable; ``auto_indent_methods``
instruments every public method of a class.  The indentation state is
thread-local (the reference does the same, logger.py:16-26) so parallel
host threads do not interleave their trees.
"""
from __future__ import annotations

import functools
import inspect
import logging
import threading

# silence matplotlib chatter (reference logger.py:6) — but only when the
# host application has not configured that logger itself
if logging.getLogger("matplotlib").level == logging.NOTSET:
    logging.getLogger("matplotlib").setLevel(logging.ERROR)

__all__ = ["HierLogger", "hlog"]


class HierLogger:
    """Logger with automatic hierarchical indentation."""

    INDENT_STR = "|   "

    def __init__(self, name: str = "opticomlib_tpu_torch"):
        self._local = threading.local()
        self.logger = logging.getLogger(name)

    # -- state ----------------------------------------------------------
    def _state(self):
        if not hasattr(self._local, "indent"):
            self._local.indent = 0
        return self._local

    class _Indent:
        def __init__(self, outer):
            self.outer = outer

        def __enter__(self):
            self.outer._state().indent += 1

        def __exit__(self, *exc):
            self.outer._state().indent -= 1

    def indent(self):
        """Context manager: one level deeper for the duration."""
        return self._Indent(self)

    # -- decorators ------------------------------------------------------
    def auto_indent(self, func=None):
        """Decorator: log the call name at the current level and indent
        everything the call emits one level deeper, so nested instrumented
        calls print as a tree (reference logger.py:63-85 behavior)."""
        def decorate(f):
            @functools.wraps(f)
            def wrapper(*args, **kwargs):
                self.debug(f.__name__)
                with self._Indent(self):
                    return f(*args, **kwargs)
            return wrapper
        return decorate if func is None else decorate(func)

    def auto_indent_methods(self, cls=None, *, exclude=()):
        """Class decorator: instrument every public method (and property
        accessor) with :meth:`auto_indent`."""
        def wrap(target):
            for name in list(vars(target)):
                if name.startswith("__") or name in exclude:
                    continue
                attr = vars(target)[name]
                if isinstance(attr, property):
                    setattr(target, name, property(
                        self.auto_indent(attr.fget) if attr.fget else None,
                        self.auto_indent(attr.fset) if attr.fset else None,
                        self.auto_indent(attr.fdel) if attr.fdel else None,
                        attr.__doc__))
                elif isinstance(attr, staticmethod):
                    setattr(target, name,
                            staticmethod(self.auto_indent(attr.__func__)))
                elif isinstance(attr, classmethod):
                    setattr(target, name,
                            classmethod(self.auto_indent(attr.__func__)))
                elif inspect.isfunction(attr):
                    # plain methods only — wrapping arbitrary callables
                    # (e.g. nested classes) would replace them with
                    # functions and break isinstance()/pickling
                    setattr(target, name, self.auto_indent(attr))
            return target
        return wrap if cls is None else wrap(cls)

    # -- emit ------------------------------------------------------------
    def _fmt(self, msg: str) -> str:
        level = max(self._state().indent, 0)
        return f"{self.INDENT_STR * level}/> {msg}"

    def debug(self, msg, *a, **k):
        self.logger.debug(self._fmt(msg), *a, **k)

    def info(self, msg, *a, **k):
        self.logger.info(self._fmt(msg), *a, **k)

    def warning(self, msg, *a, **k):
        self.logger.warning(self._fmt(msg), *a, **k)

    def error(self, msg, *a, **k):
        self.logger.error(self._fmt(msg), *a, **k)

    def critical(self, msg, *a, **k):
        self.logger.critical(self._fmt(msg), *a, **k)

    def setLevel(self, level):
        self.logger.setLevel(level)


#: module-level singleton used by the framework's instrumentation
hlog = HierLogger()
