"""The products of the reference, at the precision a run asks for.

``Exact`` multiplies in float32 with TF32 off: the reference.
``Fp8`` is the control: the nearest precision below the bfloat16 the
configurations compute in. Every operand of a product or convolution is
rounded to float8 e4m3 with a per-tensor scale (amax / 448), the product is
taken in float32, and the gradient that reaches its output is rounded to
float8 e5m2 the same way, as fp8 training recipes do, so the backward's
products take fp8 operands too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Operand(torch.autograd.Function):
    """Forward: ``x`` rounded to e4m3. Backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: ``x`` as it is. Backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


class Exact:
    """float32 products (the caller turns TF32 off)."""

    name = "fp32"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def linear(self, x, w, b=None):
        return self.output(F.linear(self.operand(x), self.operand(w), b))

    def einsum(self, spec, a, b):
        return self.output(torch.einsum(spec, self.operand(a), self.operand(b)))

    def conv2d(self, x, w, b=None, **kw):
        return self.output(F.conv2d(self.operand(x), self.operand(w), b, **kw))

    def conv_transpose2d(self, x, w, b=None, **kw):
        return self.output(F.conv_transpose2d(self.operand(x), self.operand(w), b, **kw))


class Fp8(Exact):
    """fp8 operands and gradients, float32 products: the control."""

    name = "fp8"

    def operand(self, x):
        return _Fp8Operand.apply(x)

    def output(self, y):
        return _Fp8Grad.apply(y)


PRECISIONS = {"fp32": Exact, "fp8": Fp8}
