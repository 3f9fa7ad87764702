"""FLOP counts of a callable's tensor operations, from their shapes (frozen
from the port's ``utils/flops.py``, its FLOP rules alone: the benchmark's
mfu reads them).

Counterpart of ``_conv_flops`` in the JAX package's
``tools/parse_trace.py``, without their fallback: where that tool reads the
counts from XLA's HLO text, this counts them from the shapes of the operands
and results that each operation of a PyTorch program sees (a
``TorchDispatchMode``, the one pass that sees results as well as operands),
on any device.

* A convolution is ``2·N·Ho·Wo·Co·kh·kw·Ci/groups``. A transposed one is
  counted on its input, ``2·N·Hi·Wi·Ci·kh·kw·Co/groups``: PyTorch's forward
  convention, and XLA's lhs-dilated convolution with the multiplications by
  the inserted zeros left out.
* ``convolution_backward`` counts grad-input and grad-weight each at the
  forward's count, as its ``output_mask`` asks for them.
* ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``matmul``, ``linear`` and
  ``_int_mm`` are ``2·M·N·K``; their backward runs as such products and is
  counted by the same rule.
* Every other operation counts no FLOPs.

``torch.utils.flop_counter.FlopCounterMode`` is not used: it loses the
group division on one side of a grouped convolution's backward.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

class OpCount(NamedTuple):
    """One operation: its schema name (``aten::convolution``) and FLOPs."""
    name: str
    flops: int


def conv_flops(x_shape: Sequence[int], w_shape: Sequence[int], out_shape: Sequence[int],
               transposed: bool) -> int:
    """A convolution's FLOPs from PyTorch's shapes: the weight is [Co, Ci/g,
    k...] (transposed: [Ci, Co/g, k...]), so both forms are 2 x the
    iterated tensor (output, or input when transposed) x the window x
    ``w_shape[1]``."""
    iterated = x_shape if transposed else out_shape
    return 2 * math.prod(iterated) * math.prod(w_shape[2:]) * w_shape[1]


def matmul_flops(a_shape: Sequence[int], out_shape: Sequence[int]) -> int:
    """A (batched) product's FLOPs: 2 x the result's elements x the reduced
    dimension (the last of ``a``)."""
    return 2 * math.prod(out_shape) * a_shape[-1]


def _conv(args, out, transposed: bool) -> int:
    return conv_flops(args[0].shape, args[1].shape, out.shape, transposed)


def _convolution_backward(args, out) -> int:
    # (grad_output, input, weight, bias_sizes, stride, padding, dilation,
    #  transposed, output_padding, groups, output_mask)
    grad_out, x, w = args[:3]
    mask = args[10]
    per = conv_flops(x.shape, w.shape, grad_out.shape, bool(args[7]))
    return per * (int(bool(mask[0])) + int(bool(mask[1])))


def _product(a_index: int):
    def rule(args, out) -> int:
        return matmul_flops(args[a_index].shape, out.shape)
    return rule


_FLOP_RULES = {
    "aten::convolution": lambda a, o: _conv(a, o, bool(a[6])),
    "aten::_convolution": lambda a, o: _conv(a, o, bool(a[6])),
    # under inference mode the dispatch mode sees these before they decompose
    "aten::conv2d": lambda a, o: _conv(a, o, False),
    "aten::conv_transpose2d": lambda a, o: _conv(a, o, True),
    "aten::convolution_backward": _convolution_backward,
    "aten::mm": _product(0),
    "aten::bmm": _product(0),
    "aten::matmul": _product(0),
    "aten::linear": _product(0),
    "aten::_int_mm": _product(0),
    "aten::addmm": _product(1),
    "aten::baddbmm": _product(1),
}


class OpCounter(TorchDispatchMode):
    """Records an ``OpCount`` for each operation run under it, in the order
    they run (the backward's too). ``torch.while_loop``'s operator runs eagerly under the counter, each of
    its condition's and body's operations counted."""

    supports_higher_order_operators = True

    def __init__(self):
        super().__init__()
        self.ops: List[OpCount] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            if func.name() != "while_loop":
                return NotImplemented
            from torch._higher_order_ops.while_loop import while_loop_dense
            with self:
                return while_loop_dense(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._schema.name
        rule = _FLOP_RULES.get(name)
        self.ops.append(OpCount(name, rule(args, out) if rule else 0))
        return out


def count(fn: Callable[[], Any]) -> Tuple[Any, List[OpCount]]:
    """(``fn()``, the ``OpCount`` of every operation it ran, in order)."""
    with OpCounter() as counter:
        out = fn()
    return out, counter.ops


def total_flops(ops: Sequence[OpCount]) -> int:
    """The convolution and product FLOPs of ``ops``."""
    return sum(o.flops for o in ops)
