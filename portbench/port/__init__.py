"""How each kind of model calls the program under test (the PyTorch and
CUDA port). The port receives the benchmark's int8 arrays as its own
``QuantizedMLP`` objects; what it derives from them (packed weights) is its
own state."""
from __future__ import annotations


def quantized_mlp(e_in: int, layers):
    """The port's QuantizedMLP holding the reference's layers' tensors."""
    from repro_torch.quant import QuantizedLinear, QuantizedMLP
    return QuantizedMLP(e_in=e_in, layers=tuple(
        QuantizedLinear(w_q=l.w, bias_q=l.b, shift=l.shift, relu=l.relu,
                        e_w=l.e_w, e_out=l.e_out) for l in layers))
