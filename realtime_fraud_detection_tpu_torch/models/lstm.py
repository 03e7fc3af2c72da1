"""LSTM sequential fraud model.

Port of the JAX package's ``models/lstm.py``: one fused gate matmul per step
over ``[x ; h]``, a masked front-padded history (short histories keep their
state instead of ingesting pad rows), bf16 gate products and f32 state. The
``lax.scan`` over the T steps is a Python loop here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core.precision import matmul_cd


def init_lstm_params(rng: np.random.Generator, feature_dim: int = 64,
                     hidden: int = 128, head_hidden: int = 64
                     ) -> Dict[str, torch.Tensor]:
    """Glorot-initialised LSTM + MLP-head parameters, forget bias 1."""
    scale_in = float(np.sqrt(2.0 / (feature_dim + hidden + 4 * hidden)))
    b_gates = np.zeros((4 * hidden,), np.float32)
    b_gates[hidden:2 * hidden] = 1.0
    params = {
        "w_gates": rng.standard_normal((feature_dim + hidden, 4 * hidden)) * scale_in,
        "b_gates": b_gates,
        "w_head1": rng.standard_normal((hidden, head_hidden)) * np.sqrt(2.0 / hidden),
        "b_head1": np.zeros((head_hidden,)),
        "w_head2": rng.standard_normal((head_hidden, 1)) * np.sqrt(2.0 / head_hidden),
        "b_head2": np.zeros((1,)),
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in params.items()}


def lstm_logits(params: Dict[str, torch.Tensor],
                sequences: torch.Tensor,          # f32[B, T, F] front-padded
                lengths: torch.Tensor | None = None,  # i32[B] valid suffix
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fraud logit per sequence. f32[B]."""
    b, t, _ = sequences.shape
    hidden = params["w_head1"].shape[0]
    w = params["w_gates"]
    bg = params["b_gates"]
    steps = torch.arange(t, device=sequences.device)[:, None]
    if lengths is None:
        step_valid = torch.ones((t, b), dtype=torch.bool,
                                device=sequences.device)
    else:
        # front-padded: step i is valid iff i >= T - length
        step_valid = steps >= (t - lengths)[None, :]

    h = torch.zeros((b, hidden), dtype=torch.float32, device=sequences.device)
    c = torch.zeros_like(h)
    for i in range(t):
        z = matmul_cd(torch.cat([sequences[:, i], h], dim=-1), w,
                      compute_dtype) + bg
        ig, fg, g, o = torch.split(z, hidden, dim=-1)
        c_new = torch.sigmoid(fg) * c + torch.sigmoid(ig) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = step_valid[i][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)

    z = torch.relu(h @ params["w_head1"] + params["b_head1"])
    return (z @ params["w_head2"] + params["b_head2"])[:, 0]
