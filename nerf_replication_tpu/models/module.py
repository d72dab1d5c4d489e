"""Parameter-tree modules: the part of ``flax.linen`` this repo uses.

A :class:`Module` subclass is a dataclass of static settings.
``init(key, *args)`` runs a method once and returns the parameters it
created as ``{"params": tree}``; ``apply(variables, *args)`` runs a
method with those parameters. Inside a method, ``self.param(name,
init_fn, *args)`` reads (or, under ``init``, creates) a parameter.

Submodules own the sub-tree of their name, named as flax names them:

* a dataclass field holding a module is named after the field;
* an attribute assigned in ``setup()`` is named after the attribute, and
  a list ``name`` of modules gives ``name_0``, ``name_1``, ...

so parameter trees written by flax (the committed checkpoints) load and
evaluate unchanged. :class:`Dense` computes as ``flax.linen.Dense`` and
initialises with its defaults (LeCun-normal kernel, zero bias). Each
parameter's init key is derived as flax derives it (the SHA-1 of the
module path and the scope's parameter counter, folded into the root
key), so ``init`` returns the values flax's ``init`` returns.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Any, Callable

import jax
import jax.numpy as jnp


def lecun_normal(key, shape, dtype=jnp.float32):
    """flax's default Dense kernel init: variance_scaling(1, fan_in,
    truncated normal); fan_in is the product of all but the last axis."""
    fan_in = 1
    for s in shape[:-1]:
        fan_in *= s
    # in ``dtype``, as flax computes it; 0.8796... is the stddev of a
    # standard normal truncated to [-2, 2]
    std = (jnp.sqrt(jnp.array(1.0 / fan_in, dtype))
           / jnp.array(0.87962566103423978, dtype))
    return jax.random.truncated_normal(key, -2.0, 2.0, shape, dtype) * std


def zeros_init(key, shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def constant_init(value):
    def init(key, shape, dtype=jnp.float32):
        return jnp.full(shape, value, dtype)
    return init


def _fold_in_path(rng, path: tuple):
    """flax's static fold-in: the first 4 bytes of the SHA-1 of the path's
    names and counters, folded into ``rng``."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(
        rng, jnp.uint32(int.from_bytes(m.digest()[:4], byteorder="big")))


class _Scope:
    """One node of the parameter tree. ``rng`` is set under ``init`` (new
    parameters are created), None under ``apply`` (all must exist)."""

    def __init__(self, params: dict, rng, path: tuple = ()):
        self.params = params
        self.rng = rng
        self.path = path
        self.counter = 0        # parameters created in this scope

    def child(self, name: str) -> "_Scope":
        if self.rng is None:
            sub = self.params.get(name, {})
        else:
            sub = self.params.setdefault(name, {})
        return _Scope(sub, self.rng, self.path + (name,))

    def param(self, name: str, init_fn: Callable, *args):
        if name in self.params:
            return self.params[name]
        if self.rng is None:
            raise KeyError(f"missing parameter {'/'.join(self.path)}/{name}")
        self.counter += 1
        value = init_fn(_fold_in_path(self.rng, self.path + (self.counter,)),
                        *args)
        self.params[name] = value
        return value


def _prune(tree: dict) -> dict:
    """Drop the empty sub-trees of modules that created no parameter."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if not v:
                continue
        out[k] = v
    return out


class Module:
    """Base class; see the module docstring."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(eq=False)(cls)

    def setup(self):
        """Define submodules and parameters; runs when the module binds."""

    # -- binding ----------------------------------------------------------
    def _bind(self, scope: _Scope) -> "Module":
        bound = copy.copy(self)
        object.__setattr__(bound, "_scope", scope)
        for f in dataclasses.fields(bound):
            v = getattr(bound, f.name)
            if isinstance(v, Module):
                object.__setattr__(bound, f.name, v._bind(scope.child(f.name)))
        bound.setup()
        return bound

    def __setattr__(self, name: str, value: Any):
        scope = self.__dict__.get("_scope")
        if scope is not None and not name.startswith("_"):
            if isinstance(value, Module):
                value = value._bind(scope.child(name))
            elif (isinstance(value, (list, tuple)) and value
                  and all(isinstance(v, Module) for v in value)):
                value = type(value)(
                    v._bind(scope.child(f"{name}_{i}"))
                    for i, v in enumerate(value))
        object.__setattr__(self, name, value)

    def param(self, name: str, init_fn: Callable, *args):
        scope = self.__dict__.get("_scope")
        if scope is None:
            raise RuntimeError(
                f"{type(self).__name__}.param outside init/apply")
        return scope.param(name, init_fn, *args)

    # -- entry points -------------------------------------------------------
    @staticmethod
    def _run(bound, method, args, kwargs):
        if method is None:
            return bound(*args, **kwargs)
        return method(bound, *args, **kwargs)

    def init(self, key, *args, method=None, **kwargs) -> dict:
        params: dict = {}
        self._run(self._bind(_Scope(params, key)), method, args, kwargs)
        return {"params": _prune(params)}

    def apply(self, variables: dict, *args, method=None, **kwargs):
        bound = self._bind(_Scope(variables["params"], None))
        return self._run(bound, method, args, kwargs)


class Dense(Module):
    """``y = x @ kernel + bias`` computed in ``dtype`` (default: the
    promoted type of the input and parameters), like flax.linen.Dense."""

    features: int
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = lecun_normal
    bias_init: Callable = zeros_init

    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), self.param_dtype)
        bias = self.param("bias", self.bias_init, (self.features,),
                          self.param_dtype)
        dtype = self.dtype or jnp.result_type(x, kernel, bias)
        x, kernel, bias = (jnp.asarray(a, dtype) for a in (x, kernel, bias))
        y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y + bias.reshape((1,) * (y.ndim - 1) + (-1,))
