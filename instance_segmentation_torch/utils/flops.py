"""FLOP and byte counts of a callable's tensor operations, from their shapes.

Counterpart of ``_shape_bytes`` and ``_conv_flops`` in the JAX package's
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
* An operation's bytes are its tensor operands read once plus its tensor
  results written once (``parse_trace.py``'s model: an upper bound where an
  operand is read twice or a result aliases an operand, never under).

``torch.utils.flop_counter.FlopCounterMode`` is not used: it loses the
group division on one side of a grouped convolution's backward.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the dtype whose peak a product's FLOPs are held to (kernels/bounds.py)
_PRODUCT_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
                   torch.int8: "int8"}


class OpCount(NamedTuple):
    """One operation: its schema name (``aten::convolution``), FLOPs, bytes
    moved, the dtype its FLOPs run in (None for no FLOPs) and its operands'
    shapes."""
    name: str
    flops: int
    bytes: int
    dtype: Optional[str]
    shapes: str


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


def tensor_bytes(tree: Any) -> int:
    """The bytes of every tensor in a (nested) argument or result."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _shapes(args) -> str:
    return "x".join(str(list(t.shape)) for t in tree_leaves(args) if isinstance(t, torch.Tensor))


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
# the operand whose dtype sets a product's peak
_DTYPE_OPERAND = {"aten::addmm": 1, "aten::baddbmm": 1, "aten::convolution_backward": 1}


def product_dtype(name: str, args) -> str:
    """The peak a product's FLOPs run at: its operands' dtype, and "tf32"
    for float32 where PyTorch lets cuDNN (convolutions) or cuBLAS (products)
    use TF32."""
    dtype = _PRODUCT_DTYPES.get(args[_DTYPE_OPERAND.get(name, 0)].dtype)
    if dtype is None:
        raise ValueError(f"{name}: no peak for {args[0].dtype}")
    if dtype == "f32":
        conv = "conv" in name
        tf32 = (torch.backends.cudnn.allow_tf32 if conv
                else torch.backends.cuda.matmul.allow_tf32)
        if tf32:
            return "tf32"
    return dtype


def op_count(name: str, args, kwargs, out) -> OpCount:
    """The counts of one operation ``name`` on ``args`` and ``kwargs`` giving
    ``out``."""
    rule = _FLOP_RULES.get(name)
    flops = rule(args, out) if rule else 0
    return OpCount(name, flops, tensor_bytes((args, kwargs)) + tensor_bytes(out),
                   product_dtype(name, args) if rule else None, _shapes(args))


class OpCounter(TorchDispatchMode):
    """Records an ``OpCount`` for each operation run under it, in the order
    they run (the backward's too). ``paused()`` runs code uncounted.
    ``torch.while_loop``'s operator runs eagerly under the counter, each of
    its condition's and body's operations counted."""

    supports_higher_order_operators = True

    def __init__(self):
        super().__init__()
        self.ops: List[OpCount] = []
        self._on = True

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        self._on = False
        try:
            yield
        finally:
            self._on = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            if func.name() != "while_loop":
                return NotImplemented
            from torch._higher_order_ops.while_loop import while_loop_dense
            with self:
                return while_loop_dense(*args, **kwargs)
        out = func(*args, **kwargs)
        if self._on:
            self.ops.append(op_count(func._schema.name, args, kwargs, out))
        return out


def count(fn: Callable[[], Any]) -> Tuple[Any, List[OpCount]]:
    """(``fn()``, the ``OpCount`` of every operation it ran, in order)."""
    with OpCounter() as counter:
        out = fn()
    return out, counter.ops


def total_flops(ops: Sequence[OpCount]) -> int:
    """The convolution and product FLOPs of ``ops``."""
    return sum(o.flops for o in ops)
