"""A small module layer with the part of the ``flax.linen`` interface that
the layers and models of this package use.

Modules are dataclasses whose ``__call__`` builds parameters on first use
(``@compact`` style). ``init`` runs a module once to create its variables;
``apply`` runs it with given variables. Variables live in collections
(``params``, ``batch_stats``) as nested dicts keyed by submodule name, so a
parameter tree reads ``params["conv_0"]["fc_self"]["kernel"]``.

Supported: ``Module`` with ``param``, ``variable``, ``make_rng`` and
``is_initializing``; ``init(rngs, ...)`` and ``apply(variables, ...,
rngs=..., mutable=...)``; submodules named explicitly or automatically
(``Dense_0``); ``Dense``, ``Dropout``, ``Embed`` and ``remat``. Activations
and ``initializers`` are re-exported from ``jax.nn``.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.nn import (  # noqa: F401  (re-exported activations)
    elu,
    gelu,
    leaky_relu,
    log_sigmoid,
    log_softmax,
    relu,
    sigmoid,
    softmax,
)
from jax.nn import initializers

__all__ = [
    "Module", "compact", "Dense", "Dropout", "Embed", "remat", "initializers",
    "elu", "gelu", "leaky_relu", "log_sigmoid", "log_softmax", "relu",
    "sigmoid", "softmax",
]

Path = Tuple[str, ...]

_context = threading.local()


def _stack() -> list:
    if not hasattr(_context, "modules"):
        _context.modules = []
    return _context.modules


def compact(fn: Callable) -> Callable:
    """Marks a ``__call__`` that creates its submodules and parameters inline.
    Every module method works that way here, so this is a no-op kept for
    readability."""
    return fn


class _Frame:
    """Variables, rngs and mutability shared by every module of one
    ``init``/``apply`` run."""

    def __init__(self, variables: Dict[str, dict], rngs: Dict[str, Any],
                 mutable, initializing: bool):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable  # True (all collections) or a set of names
        self.initializing = initializing
        self.rng_counts: Dict[Tuple[Path, str], int] = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def get(self, col: str, path: Path, name: str, default=None):
        node = self.variables.get(col)
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        if not isinstance(node, dict):
            return default
        return node.get(name, default)

    def put(self, col: str, path: Path, name: str, value) -> None:
        node = self.variables.setdefault(col, {})
        for p in path:
            node = node.setdefault(p, {})
        node[name] = value


def _copy_dicts(tree):
    """Copy the dict nodes of a nested dict (leaves shared)."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _subtree(tree: dict, path: Path) -> dict:
    for p in path:
        tree = tree.get(p, {}) if isinstance(tree, dict) else {}
    return tree


def _nest(path: Path, tree: dict) -> dict:
    for p in reversed(path):
        tree = {p: tree}
    return tree


class Variable:
    """A named variable of one collection; ``.value`` reads and writes it."""

    def __init__(self, frame: _Frame, col: str, path: Path, name: str):
        self._frame, self._col, self._path, self._name = frame, col, path, name

    @property
    def value(self):
        return self._frame.get(self._col, self._path, self._name)

    @value.setter
    def value(self, v):
        if not self._frame.is_mutable(self._col):
            raise ValueError(
                f"collection {self._col!r} is not mutable here; pass "
                f"mutable=[{self._col!r}] to apply")
        self._frame.put(self._col, self._path, self._name, v)


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses are dataclasses whose fields are the module's
    configuration; ``name`` names the module inside its parent."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False)
        if "__call__" in cls.__dict__:
            cls.__call__ = _bound_call(cls.__dict__["__call__"])

    def __post_init__(self):
        self._reset(None)
        stack = _stack()
        if stack:  # created inside a running module: becomes its child
            stack[-1]._register_child(self)

    # -- binding ----------------------------------------------------------
    def _reset(self, scope) -> None:
        object.__setattr__(self, "_scope", scope)
        object.__setattr__(self, "_child_counts", {})
        object.__setattr__(self, "_child_names", set())
        object.__setattr__(self, "_adopted", {})

    def _detached(self, scope) -> "Module":
        """A copy bound to ``scope`` that no running module adopts."""
        new = copy.copy(self)
        new._reset(scope)
        return new

    def _register_child(self, child: "Module") -> None:
        frame, path = self._scope
        name = child.name
        if name is None:
            cls_name = type(child).__name__
            n = self._child_counts.get(cls_name, 0)
            self._child_counts[cls_name] = n + 1
            name = f"{cls_name}_{n}"
            object.__setattr__(child, "name", name)
        if name in self._child_names:
            raise ValueError(
                f"submodule name {name!r} used twice in {'/'.join(path) or '<root>'}")
        self._child_names.add(name)
        object.__setattr__(child, "_scope", (frame, path + (name,)))

    def _bound(self) -> "Module":
        """This module, or its bound copy when it was built outside the
        running parent (a module passed in as a field)."""
        if self._scope is not None:
            return self
        stack = _stack()
        if not stack:
            raise ValueError(
                f"{type(self).__name__} is unbound: call it through "
                "init/apply or from inside another module")
        parent = stack[-1]
        adopted = parent._adopted.get(id(self))
        if adopted is None:
            adopted = dataclasses.replace(self)  # registers with the parent
            parent._adopted[id(self)] = adopted
        return adopted

    # -- variables ----------------------------------------------------------
    def _require_scope(self) -> Tuple[_Frame, Path]:
        if self._scope is None:
            raise ValueError(f"{type(self).__name__} is unbound")
        return self._scope

    def param(self, name: str, init_fn: Callable, *init_args):
        """The parameter ``name``, created as ``init_fn(rng, *init_args)``
        when the module is initializing."""
        frame, path = self._require_scope()
        value = frame.get("params", path, name)
        if value is None:
            if not frame.is_mutable("params"):
                raise ValueError(
                    f"parameter {'/'.join(path + (name,))} missing from the "
                    "variables given to apply")
            value = init_fn(self.make_rng("params"), *init_args)
            frame.put("params", path, name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args) -> Variable:
        """A variable of collection ``col``, created as ``init_fn(*init_args)``
        when missing and the collection is mutable."""
        frame, path = self._require_scope()
        if frame.get(col, path, name) is None:
            if not frame.is_mutable(col):
                raise ValueError(
                    f"variable {col}/{'/'.join(path + (name,))} missing from "
                    "the variables given to apply")
            frame.put(col, path, name, init_fn(*init_args))
        return Variable(frame, col, path, name)

    def make_rng(self, name: str):
        """A fresh key from the rng stream ``name``, distinct per module path
        and per call."""
        frame, path = self._require_scope()
        key = frame.rngs.get(name)
        if key is None:
            raise ValueError(f"{'/'.join(path) or 'module'} needs an rng named "
                             f"{name!r}; pass rngs={{{name!r}: key}}")
        n = frame.rng_counts.get((path, name), 0)
        frame.rng_counts[(path, name)] = n + 1
        key = jax.random.fold_in(key, zlib.crc32("/".join(path).encode()))
        return jax.random.fold_in(key, n)

    def is_initializing(self) -> bool:
        return self._require_scope()[0].initializing

    # -- entry points -------------------------------------------------------
    def init(self, rngs, *args, **kwargs) -> Dict[str, dict]:
        """Run the module once and return the variables it created,
        ``{collection: tree}``. ``rngs`` is a key (the ``params`` stream) or a
        dict of keys."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame({}, dict(rngs), True, True)
        self._detached((frame, ()))(*args, **kwargs)
        return frame.variables

    def apply(self, variables: Dict[str, dict], *args, rngs=None,
              mutable=False, **kwargs):
        """Run the module with ``variables``. With ``mutable`` (a collection
        name or a list of them) returns ``(output, updated collections)``."""
        if isinstance(mutable, str):
            cols = {mutable}
        elif mutable is True:
            cols = True
        else:
            cols = set(mutable or ())
        frame = _Frame(_copy_dicts(dict(variables)), dict(rngs or {}), cols, False)
        out = self._detached((frame, ()))(*args, **kwargs)
        if not mutable:
            return out
        names = frame.variables.keys() if cols is True else cols
        return out, {c: frame.variables.get(c, {}) for c in names}


def _bound_call(fn: Callable) -> Callable:
    def call(self, *args, **kwargs):
        mod = self._bound()
        stack = _stack()
        stack.append(mod)
        try:
            return fn(mod, *args, **kwargs)
        finally:
            stack.pop()

    call.__wrapped__ = fn
    call.__doc__ = fn.__doc__
    return call


class Dense(Module):
    """``x @ kernel + bias`` over the last axis (kernel: (in, features))."""

    features: int
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init, (x.shape[-1], self.features))
        y = jnp.dot(x, kernel)
        if self.use_bias:
            y = y + self.param("bias", self.bias_init, (self.features,))
        return y


class Dropout(Module):
    """Inverted dropout; identity when deterministic or ``rate == 0``. Draws
    its mask from the ``dropout`` rng stream."""

    rate: float
    deterministic: Optional[bool] = None

    def __call__(self, x, deterministic: Optional[bool] = None):
        det = self.deterministic if deterministic is None else deterministic
        if det is None:
            raise ValueError("Dropout needs deterministic=True or False")
        if det or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, x.shape)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))


class Embed(Module):
    """Lookup table of ``num_embeddings`` rows of width ``features``."""

    num_embeddings: int
    features: int
    embedding_init: Callable = initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0)

    def __call__(self, idx):
        if not jnp.issubdtype(idx.dtype, jnp.integer):
            raise ValueError(f"Embed takes integer indices, got {idx.dtype}")
        table = self.param("embedding", self.embedding_init,
                           (self.num_embeddings, self.features))
        return jnp.take(table, idx, axis=0)


def remat(module_cls, static_argnums: Sequence[int] = ()):
    """``module_cls`` whose ``__call__`` is rematerialized in the backward
    pass (``jax.checkpoint``). ``static_argnums`` index the call's positional
    arguments with ``self`` as 0. Keyword arguments are not supported, and
    the call may not write variables; initialization runs unwrapped."""
    raw = module_cls.__call__.__wrapped__
    static = tuple(static_argnums)

    def __call__(self, *args):
        frame, path = self._scope
        if frame.initializing:
            return raw(self, *args)
        variables = {c: _subtree(t, path) for c, t in frame.variables.items()}

        def fn(variables, rngs, *args):
            sub = _Frame({c: _nest(path, t) for c, t in variables.items()},
                         rngs, set(), False)
            mod = self._detached((sub, path))
            _stack().append(mod)
            try:
                return raw(mod, *args)
            finally:
                _stack().pop()

        # fn's arguments are (variables, rngs, *args): argument i of the
        # call (self = 0) is argument i + 1 of fn
        ckpt = jax.checkpoint(fn, static_argnums=tuple(i + 1 for i in static))
        return ckpt(variables, frame.rngs, *args)

    return type(module_cls.__name__, (module_cls,), {"__call__": __call__})
