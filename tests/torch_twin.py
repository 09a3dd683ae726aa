"""Run the JAX package's own tests against the port.

A twin stands in for a JAX module, class or function inside a JAX test:
each call goes to the JAX object and to the port's counterpart with the
same arguments, the two results are held to each other, and the port's
result goes back to the test, whose own assertions then judge it.

Results compare by value: dataclasses field by field (by class name, so
the two packages' classes match), containers item by item, bytes and
integer arrays exactly, float arrays within `rtol`.  An object that is
not plain data (a writer, a reader, a decoder) comes back as a twin
itself, so its methods and attributes are held to each other in turn;
so does a list, dict, set or dataclass read from an object's attribute
(or from such a container), so that the test's changes to it reach both
objects.  Both calls must raise alike:
the same exception class name and message.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np

_SCALARS = (bool, int, float, str, bytes, bytearray, type(None))


def _array(v):
    """A JAX array, torch tensor or numpy array as numpy, else None."""
    if isinstance(v, np.ndarray):
        return v
    mod = type(v).__module__
    if mod.startswith("torch"):
        return v.detach().cpu().numpy()
    if mod.startswith(("jax", "jaxlib")):
        return np.asarray(v)
    return None


def is_data(v) -> bool:
    if isinstance(v, _SCALARS + (np.generic,)) or _array(v) is not None:
        return True
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return all(is_data(getattr(v, f.name))
                   for f in dataclasses.fields(v))
    if isinstance(v, (list, tuple, set, frozenset)):
        return all(is_data(x) for x in v)
    if isinstance(v, dict):
        return all(is_data(x) for x in v.values())
    return False


def assert_same(a, b, rtol: float = 0.0, where: str = "") -> None:
    """a (JAX) and b (port) hold the same value; float arrays within
    rtol of a (with an absolute floor of rtol)."""
    xa, xb = _array(a), _array(b)
    if xa is not None or xb is not None:
        assert xa is not None and xb is not None, where
        assert xa.shape == xb.shape and xa.dtype == xb.dtype, \
            f"{where}: {xa.dtype}{xa.shape} vs {xb.dtype}{xb.shape}"
        if rtol and xa.dtype.kind == "f":
            np.testing.assert_allclose(xb, xa, rtol=rtol, atol=rtol,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(xb, xa, err_msg=where)
        return
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), rtol,
                        f"{where}.{f.name}")
        return
    if isinstance(a, (list, tuple)):
        assert (isinstance(b, (list, tuple)) and len(a) == len(b)
                and type(a).__name__ == type(b).__name__), \
            f"{where}: {type(a).__name__}[{len(a)}] vs {b!r:.80}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, rtol, f"{where}[{i}]")
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), \
            f"{where}: keys {list(a)} vs {b!r:.80}"
        for k in a:
            assert_same(a[k], b[k], rtol, f"{where}[{k!r}]")
        return
    if isinstance(a, float) and rtol:
        assert abs(a - b) <= rtol * max(1.0, abs(a)), f"{where}: {a} vs {b}"
        return
    assert a == b, f"{where}: {a!r:.200} vs {b!r:.200}"


def _side(v, i: int):
    """The JAX (0) or port (1) side of a value that may hold twins."""
    if isinstance(v, Twin):
        return v._pair[i]
    if isinstance(v, list):
        return [_side(x, i) for x in v]
    if isinstance(v, tuple):
        return tuple(_side(x, i) for x in v)
    if isinstance(v, dict):
        return {k: _side(x, i) for k, x in v.items()}
    return v


def _call(fn, args, kw):
    try:
        return fn(*args, **kw), None
    except Exception as e:      # held to the other side's below
        return None, e


class Twin:
    """The pair (JAX object, port object) seen as one object."""

    def __init__(self, ref, port, rtol: float = 0.0, port_kw=None,
                 name: str = ""):
        object.__setattr__(self, "_pair", (ref, port))
        object.__setattr__(self, "_rtol", rtol)
        # extra keywords for the port's callables that accept them, e.g.
        # device="cpu" for entry points that default to the card
        object.__setattr__(self, "_port_kw", dict(port_kw or {}))
        object.__setattr__(self, "_name", name or getattr(ref, "__name__",
                                                          type(ref).__name__))

    def _wrap(self, a, b, name, live: bool = False):
        """b where a and b hold the same data; a twin where they are
        objects, or (`live`) containers that the caller may change."""
        if is_data(a) and is_data(b):
            assert_same(a, b, self._rtol, name)
            if not (live and (isinstance(b, (list, dict, set))
                              or dataclasses.is_dataclass(b))):
                return b
        return Twin(a, b, self._rtol, self._port_kw, name)

    def __getattr__(self, attr):
        ref, port = self._pair
        return self._wrap(getattr(ref, attr), getattr(port, attr),
                          f"{self._name}.{attr}", live=True)

    def _both(self, op, other):
        """op on each side: the same answer from both, the port's."""
        a, b = op(self._pair[0], _side(other, 0)), op(self._pair[1],
                                                      _side(other, 1))
        return self._wrap(a, b, self._name)

    def __eq__(self, other):
        return self._both(lambda x, y: x == y, other)

    def __ne__(self, other):
        return self._both(lambda x, y: x != y, other)

    __hash__ = None

    def __contains__(self, item):
        return self._both(lambda x, y: y in x, item)

    def __bool__(self):
        return self._both(lambda x, _y: bool(x), None)

    def __setattr__(self, attr, value):
        setattr(self._pair[0], attr, _side(value, 0))
        setattr(self._pair[1], attr, _side(value, 1))

    def __call__(self, *args, **kw):
        ref, port = self._pair
        pkw = dict(_side(kw, 1))
        try:
            params = inspect.signature(port).parameters
        except (TypeError, ValueError):
            params = {}
        for k, v in self._port_kw.items():
            if k in params:
                pkw.setdefault(k, v)
        ra, ea = _call(ref, _side(args, 0), _side(kw, 0))
        rb, eb = _call(port, _side(args, 1), pkw)
        if ea is not None or eb is not None:
            assert ea is not None and eb is not None, \
                f"{self._name}: JAX raised {ea!r}, the port {eb!r}"
            assert (type(ea).__name__, str(ea)) == \
                (type(eb).__name__, str(eb)), f"{self._name}: {ea!r} vs {eb!r}"
            raise eb
        return self._wrap(ra, rb, f"{self._name}()")

    def __iter__(self):
        ref, port = self._pair
        for i, (a, b) in enumerate(zip(ref, port, strict=True)):
            yield self._wrap(a, b, f"{self._name}[{i}]", live=True)

    def __len__(self):
        n = len(self._pair[0])
        assert n == len(self._pair[1]), self._name
        return n

    def __getitem__(self, key):
        ref, port = self._pair
        return self._wrap(ref[_side(key, 0)], port[_side(key, 1)],
                          f"{self._name}[{key!r}]", live=True)
