"""Forward-mode dual numbers over torch tensors: the autodiff gradient set
as explicit tangent arithmetic.

`Dual(v, t)` carries a value v of any shape S and its tangents t, of shape
(N,) + S' with S' broadcastable to S: one row per seeded input. The value
chain of ops/dispersion.py (mu_2d_lat, mu_2d_colat, mu_3d) runs on Duals
unchanged: arithmetic with Python floats and tensors goes through the
operators below, and the torch functions the chain calls (sin, exp,
sqrt, clamp, where, maximum, ...) through __torch_function__. A tensor or
a Python float in the chain is a constant: it has no tangent (as
torch.zeros_like makes the dipole's B_phi, or an env scalar).

Each tangent rule is torch's forward-mode formula for the op (tools/
autograd/derivatives.yaml of PyTorch: mul.Tensor `other_t * self_p +
self_t * other_p`, div.Tensor `(self_t - other_t * result) / other_p`,
sqrt `grad / (2 * result)`, maximum with weight 0.5 at ties, ...), each
operation a separate torch op in the formula's order, so that the step
kernel's dual type (csrc/step_chunk.cu, the AD medium) performs the same
operations per tangent row and rounds as this does, bit for bit, on the
card. `value_and_grads` seeds one row per input: the N partials of one
evaluation, the derivative that torch.func.jvp would push through the
same chain (tests/test_torch_autodiff.py holds the two together and both
to the JAX package's value_and_grad).

A Python-scalar quotient `x / c` runs on the card as a product with the
reciprocal, and `c / x` is torch's `x.reciprocal() * c`; the kernel forms
both the same way.
"""

import torch


class Dual:
    """A value and its tangent rows (see the module docstring)."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v = v
        self.t = t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _RULES.get(func) or _METHODS.get(getattr(func, "__name__", ""))
        if rule is None:
            raise NotImplementedError(f"Dual has no tangent rule for {func}")
        return rule(*args, **(kwargs or {}))

    # arithmetic: the value with the same operator and operand order as
    # on plain tensors, the tangent by torch's formula
    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(other, self)

    def __sub__(self, other):
        return sub(self, other)

    def __rsub__(self, other):
        return sub(other, self)

    def __mul__(self, other):
        return mul(self, other)

    def __rmul__(self, other):
        return mul(other, self)

    def __truediv__(self, other):
        return div(self, other)

    def __rtruediv__(self, other):
        return div(other, self)

    def __neg__(self):
        return Dual(-self.v, -self.t)

    def __pow__(self, exponent):
        # pow.Tensor_Scalar at exponent 2 (the only power of the chain):
        # pow_backward, grad * (2 * self^1)
        if exponent != 2:
            raise NotImplementedError("Dual ** takes the exponent 2 only")
        return Dual(self.v ** 2, self.t * (2.0 * self.v))

    # comparisons read the value
    def __le__(self, other):
        return self.v <= _value(other)

    def __lt__(self, other):
        return self.v < _value(other)

    def __ge__(self, other):
        return self.v >= _value(other)

    def __gt__(self, other):
        return self.v > _value(other)


def _value(x):
    return x.v if isinstance(x, Dual) else x


def _parts(x):
    return (x.v, x.t) if isinstance(x, Dual) else (x, None)


def add(a, b):
    av, at = _parts(a)
    bv, bt = _parts(b)
    if at is None:
        return Dual(av + bv, bt)
    return Dual(av + bv, at if bt is None else at + bt)


def sub(a, b):
    av, at = _parts(a)
    bv, bt = _parts(b)
    if at is None:      # rsub: -grad
        return Dual(av - bv, -bt)
    return Dual(av - bv, at if bt is None else at - bt)


def mul(a, b):
    av, at = _parts(a)
    bv, bt = _parts(b)
    if at is None:
        return Dual(av * bv, bt * av)
    if bt is None:
        return Dual(av * bv, at * bv)
    return Dual(av * bv, bt * av + at * bv)


def div(a, b):
    av, at = _parts(a)
    bv, bt = _parts(b)
    if bt is None:      # div.Scalar / div.Tensor by a constant: self_t / other
        return Dual(av / bv, at / bv)
    if at is None:
        if isinstance(av, torch.Tensor):
            raise NotImplementedError("Dual: a tensor over a Dual")
        # c / x is x.reciprocal() * c: reciprocal's -grad * (result *
        # result), then mul.Scalar
        rr = torch.reciprocal(bv)
        return Dual(rr * av, (-bt * (rr * rr)) * av)
    res = av / bv
    return Dual(res, (at - bt * res) / bv)


def _sin(x):
    return Dual(torch.sin(x.v), x.t * torch.cos(x.v))


def _cos(x):
    return Dual(torch.cos(x.v), x.t * -torch.sin(x.v))


def _exp(x):
    v = torch.exp(x.v)
    return Dual(v, x.t * v)


def _log(x):
    return Dual(torch.log(x.v), x.t / x.v)


def _sqrt(x):
    v = torch.sqrt(x.v)
    return Dual(v, x.t / (2.0 * v))


def _asin(x):
    return Dual(torch.asin(x.v), x.t * torch.rsqrt(-x.v * x.v + 1.0))


def _atan2(y, x):
    yv, yt = _parts(y)
    xv, xt = _parts(x)
    if yt is None or xt is None:
        raise NotImplementedError("Dual: atan2 of a constant")
    return Dual(torch.atan2(yv, xv),
                (-yv * xt + xv * yt) / (yv ** 2 + xv ** 2))


def _abs(x):
    return Dual(torch.abs(x.v), x.t * torch.sign(x.v))


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _clamp(x, min=None, max=None):
    if min is None or max is None:
        raise NotImplementedError("Dual: clamp takes both bounds")
    inside = (x.v >= min) & (x.v <= max)
    return Dual(torch.clamp(x.v, min, max),
                torch.where(inside, x.t, _zero(x.t)))


def _clamp_min(x, min):
    return Dual(torch.clamp_min(x.v, min),
                torch.where(x.v >= min, x.t, _zero(x.t)))


def _maximum(a, b):
    av, at = _parts(a)
    bv, bt = _parts(b)
    if at is None or bt is None:
        raise NotImplementedError("Dual: maximum with a constant")
    v = torch.maximum(av, bv)
    w = torch.where(av == bv, torch.full((), 0.5, dtype=v.dtype,
                                         device=v.device),
                    (av > bv).to(v.dtype))
    return Dual(v, bt + w * (at - bt))


def _where(cond, a, b):
    av, at = _parts(a)
    bv, bt = _parts(b)
    ref = at if at is not None else bt
    return Dual(torch.where(cond, av, bv),
                torch.where(cond, _zero(ref) if at is None else at,
                            _zero(ref) if bt is None else bt))


def _zeros_like(x, **kw):
    return torch.zeros_like(x.v, **kw)


_RULES = {
    torch.sin: _sin, torch.cos: _cos, torch.exp: _exp, torch.log: _log,
    torch.sqrt: _sqrt, torch.asin: _asin, torch.atan2: _atan2,
    torch.abs: _abs, torch.clamp: _clamp,
    torch.clamp_min: _clamp_min, torch.maximum: _maximum,
    torch.where: _where, torch.zeros_like: _zeros_like,
}
# Tensor methods reached with a Dual operand (a constant tensor op a Dual,
# e.g. the dipole's B_phi times rho)
_METHODS = {"add": add, "sub": sub, "mul": mul, "div": div}


def value_and_grads(fn, primals, *args):
    """fn(*primals, *args) and its partials w.r.t. each primal: one
    evaluation on Duals, primal k seeded with the k-th unit tangent.
    Returns (value, (d/dprimal_0, ...)), each of the value's shape."""
    n = len(primals)
    duals = []
    for k, x in enumerate(primals):
        seed = torch.zeros((n,) + (1,) * x.dim(), dtype=x.dtype,
                           device=x.device)
        seed[k] = 1.0
        duals.append(Dual(x, seed))
    out = fn(*duals, *args)
    t = out.t.expand((n,) + out.v.shape)
    return out.v, tuple(t[k] for k in range(n))
