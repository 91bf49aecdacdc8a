"""w8a8 int8 inference twin of the policy-value ResNet.

Port of ``xiangqi_alphazero_tpu.models.quant``, with the same functions
and the same arithmetic; tensors are NHWC, as the JAX module's are:

- BatchNorm FOLDED into each conv (inference uses running stats, so
  conv+BN is an affine map: W' = W * gamma/sqrt(var+eps) per out-channel,
  b' = beta - gamma*mean/sqrt(var+eps)).
- Every 3x3 conv lowered to an im2col matmul ([B*90, 9*C] @ [9*C, C']),
  int8 x int8 -> int32 through ``torch._int_mm``.
- Weights: per-output-channel symmetric int8 (scale = max|W'|/127).
- Activations: dynamic symmetric int8 with one scale per row of the
  matmul (per board cell for conv patches, per sample for the policy
  dense).
- Residual adds, ReLUs and the value head's small denses stay float32;
  the 8100-wide policy dense is quantized the same way as the convs.

``quantize_net`` folds and quantizes on the host in numpy, exactly as the
JAX module does (the same numpy code on the same flax-layout arrays), so
the int8 weights and scales are identical. In the forward, ``x / scale`` and
``amax / 127`` are divisions (a multiply by the reciprocal rounds
differently) and the dequantize order is ``acc * a_scale * w_scale +
bias``, as in the JAX module (``quant.py:132, 163-167``): the int8
activations of the first layer equal JAX's, and later ones can differ only
where float rounding moves a value across a rounding boundary. Every
operation rounds alike on the card and on the CPU.

``torch._int_mm`` on CUDA needs M > 16 and K, N multiples of 8. The stem's
K is 9 x 15 = 135, the value conv's N is 4, the policy dense's N is 8100
and its M is the batch. ``_int8_matmul`` zero-pads all three: zero rows and
columns change no int32 sum, and the padding is sliced off before the
dequantize step. The CPU takes the same padded path.

This is an inference-only twin: training and gating keep the float path.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .convert import jax_from_state_dict

ROWS, COLS = 10, 9
_EPS = 1e-5
_MIN_M = 17          # torch._int_mm on CUDA: M > 16
_ALIGN = 8           # ... and K, N multiples of 8


class QConv(NamedTuple):
    w_q: torch.Tensor      # int8 [K*K*Cin, Cout] (im2col layout)
    w_scale: torch.Tensor  # f32 [Cout]
    bias: torch.Tensor     # f32 [Cout] (folded BN shift)
    w_mm: torch.Tensor     # int8 [Cout8, K8]: w_q zero-padded and transposed


class QDense(NamedTuple):
    w_q: torch.Tensor      # int8 [In, Out]
    w_scale: torch.Tensor  # f32 [Out]
    bias: torch.Tensor     # f32 [Out]
    w_mm: torch.Tensor     # int8 [Out8, In8]


class QuantNet(NamedTuple):
    stem: QConv
    blocks: Tuple[Tuple[QConv, QConv], ...]
    policy_conv: QConv
    policy_dense: QDense
    value_conv: QConv
    value_d1: Tuple[torch.Tensor, torch.Tensor]  # f32 kernel/bias (tiny)
    value_d2: Tuple[torch.Tensor, torch.Tensor]


def _fold_bn(kernel: np.ndarray, bn_p, bn_s) -> Tuple[np.ndarray, np.ndarray]:
    """conv kernel [kh, kw, cin, cout] + BN(params, stats) ->
    (folded kernel, bias)."""
    gamma = np.asarray(bn_p["scale"], np.float32)
    beta = np.asarray(bn_p["bias"], np.float32)
    mean = np.asarray(bn_s["mean"], np.float32)
    var = np.asarray(bn_s["var"], np.float32)
    s = gamma / np.sqrt(var + _EPS)
    return np.asarray(kernel, np.float32) * s, beta - mean * s


def _quant_w(w2d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[In, Out] f32 -> (int8, per-out-channel scale)."""
    amax = np.abs(w2d).max(axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w2d / scale), -127, 127).astype(np.int8)
    return q, scale


def _round_up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _mm_weight(q: np.ndarray, device) -> torch.Tensor:
    """int8 [K, N] -> int8 [N8, K8]: zero-padded to multiples of 8 and
    transposed, so ``w_mm.t()`` is the column-major [K8, N8] operand of
    ``torch._int_mm``."""
    k, n = q.shape
    padded = np.zeros((_round_up(n), _round_up(k)), np.int8)
    padded[:n, :k] = q.T
    return torch.from_numpy(padded).to(device)


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _qconv(kernel, bn_p, bn_s, device) -> QConv:
    k, b = _fold_bn(np.asarray(kernel), bn_p, bn_s)
    kh, kw, cin, cout = k.shape
    q, s = _quant_w(k.reshape(kh * kw * cin, cout))
    return QConv(torch.from_numpy(q).to(device), _t(s, device), _t(b, device),
                 _mm_weight(q, device))


def quantize_net(net: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                 device=None) -> QuantNet:
    """Fold + quantize the port's net, or its reference-layout state dict
    (host-side numpy; call once per weight update). The tensors go to
    ``device``, by default the device of the weights."""
    sd = net.state_dict() if isinstance(net, torch.nn.Module) else net
    if device is None:
        device = next(iter(sd.values())).device
    blocks_n = len({k.split(".")[1] for k in sd if k.startswith("res_blocks.")})
    tree = jax_from_state_dict(sd, blocks_n)
    p, st = tree["params"], tree["batch_stats"]
    blocks = []
    for i in range(blocks_n):
        bp, bs = p[f"ResBlock_{i}"], st[f"ResBlock_{i}"]
        blocks.append((
            _qconv(bp["Conv_0"]["kernel"], bp["BatchNorm_0"], bs["BatchNorm_0"], device),
            _qconv(bp["Conv_1"]["kernel"], bp["BatchNorm_1"], bs["BatchNorm_1"], device),
        ))
    dq, ds = _quant_w(np.asarray(p["Dense_0"]["kernel"], np.float32))
    return QuantNet(
        stem=_qconv(p["Conv_0"]["kernel"], p["BatchNorm_0"], st["BatchNorm_0"], device),
        blocks=tuple(blocks),
        policy_conv=_qconv(p["Conv_1"]["kernel"], p["BatchNorm_1"], st["BatchNorm_1"], device),
        policy_dense=QDense(torch.from_numpy(dq).to(device), _t(ds, device),
                            _t(p["Dense_0"]["bias"], device), _mm_weight(dq, device)),
        value_conv=_qconv(p["Conv_2"]["kernel"], p["BatchNorm_2"], st["BatchNorm_2"], device),
        value_d1=(_t(p["Dense_1"]["kernel"], device), _t(p["Dense_1"]["bias"], device)),
        value_d2=(_t(p["Dense_2"]["kernel"], device), _t(p["Dense_2"]["bias"], device)),
    )


def _quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 [M, K] -> (int8 [M, K], scale f32 [M]). Dynamic symmetric
    PER-ROW scales: one reduction along the contracted axis, and the
    matmul's scale correction stays rank-1 (a_scale[m] * w_scale[n])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor on x's device: CUDA multiplies by the reciprocal of a
    # Python-number divisor, one bit off a division (and off the CPU's)
    scale = amax.clamp(min=1e-8) / amax.new_full((), 127.0)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[..., 0]


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """[B, 10, 9, C] -> [B, 10, 9, 9C] SAME-padded 3x3 patches."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dr:dr + h, dc:dc + w, :] for dr in range(3) for dc in range(3)]
    return torch.cat(cols, dim=-1)


def _int8_matmul(q_x: torch.Tensor, w_mm: torch.Tensor, n: int) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, n] -> int32 [M, n] through ``torch._int_mm``,
    with ``w_mm`` the padded, transposed weight of ``_mm_weight``. Rows are
    padded to at least 17 and K to ``w_mm``'s; zeros change no sum."""
    m, k = q_x.shape
    pad_m = max(_MIN_M - m, 0)
    if pad_m or w_mm.shape[1] != k:
        q_x = F.pad(q_x, (0, w_mm.shape[1] - k, 0, pad_m))
    return torch._int_mm(q_x, w_mm.t())[:m, :n]


def _conv(x: torch.Tensor, qc: QConv, relu: bool = True, ksize: int = 3) -> torch.Tensor:
    """Quantized conv (+folded BN) on NHWC f32 input; f32 out."""
    b = x.shape[0]
    patches = _im2col(x) if ksize == 3 else x
    q_x, a_scale = _quant_act(patches.reshape(b * ROWS * COLS, -1))
    acc = _int8_matmul(q_x, qc.w_mm, qc.w_q.shape[1])
    y = acc.float() * a_scale[:, None] * qc.w_scale[None, :] + qc.bias
    y = y.reshape(b, ROWS, COLS, -1)
    return torch.relu(y) if relu else y


def int8_forward(qn: QuantNet, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, 10, 9, 15] features -> (logits[B, 8100], value[B, 1]); the
    contract of ``XiangqiNet.forward``."""
    x = _conv(feats.float(), qn.stem)
    for c1, c2 in qn.blocks:
        y = _conv(x, c1)
        y = _conv(y, c2, relu=False)
        x = torch.relu(y + x)

    p = _conv(x, qn.policy_conv, ksize=1)
    p = p.reshape(p.shape[0], -1)
    q_p, p_scale = _quant_act(p)
    dense = qn.policy_dense
    logits = (
        _int8_matmul(q_p, dense.w_mm, dense.w_q.shape[1]).float()
        * p_scale[:, None] * dense.w_scale[None, :]
        + dense.bias
    )

    v = _conv(x, qn.value_conv, ksize=1)
    v = v.reshape(v.shape[0], -1)
    v = torch.relu(v @ qn.value_d1[0] + qn.value_d1[1])
    value = torch.tanh(v @ qn.value_d2[0] + qn.value_d2[1])
    return logits, value


def int8_logits_fn(qn: QuantNet):
    """Drop-in for ``policy_logits_fn``: (feats) -> (logits, value[B])."""

    def f(feats):
        logits, value = int8_forward(qn, feats)
        return logits, value[:, 0]

    return f
