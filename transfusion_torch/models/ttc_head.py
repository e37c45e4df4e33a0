"""Transformer TTC prediction head, the optional ``ttc_hand_head`` (port of
``transfusion_tpu/models/ttc_head.py``): a CLS token attends over the
detection's RoI box feature projected to the head width, its quantized box
coordinates (each of x0/y0/x1/y1 indexes a sinusoidal table row by
``floor(coord * emb_steps)`` through a 2-layer SiLU MLP, plus
coordinate-type embeddings), the hand boxes of the history (with hand-side,
type and step encodings) and the FrankMocap hand poses (63-d, through a
2-layer SiLU MLP), through post-norm encoder layers (ReLU, the fusion's
:class:`EncoderLayer`, plain attention as JAX's default); softplus on the
CLS output.

The reference adds the hand-side encodings with a batch-dimension indexing
slip (``ttc_pred.py:127-128`` slices dim 0 where the token dim was meant);
like the JAX module, this one adds them to the token halves as intended.

Names follow the JAX module's (``object_feat_embedder``,
``{x0,y0,x1,y1}_type_enc``, ``hand_side_enc``, ``object_box_embedder``,
``hand_box_embedder``, ``hand_pose_embedder``, ``cls_token``,
``layers.i`` for ``layer_i`` with torch's packed ``in_proj``, ``ttc_out``):
the reference translator has no mapping for this head, so its weights
cross from JAX to the port only (``weights.state_dict_from_jax``). The
layers' LayerNorms run kernel K1 in the residual form.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.fusion import EncoderLayer, sin1d_table
from transfusion_torch.models.text_encoder import linear


@dataclass(frozen=True)
class TTCHeadConfig:
    feat_dim: int = 1024
    ff_dim: int = 1024
    num_heads: int = 4
    num_layers: int = 4
    dropout: float = 0.1
    num_steps: int = 5          # hand history steps
    emb_steps_hand: int = 100   # coordinate quantization for hand boxes
    emb_steps_object: int = 100
    hand_feat_dim: int = 63
    object_feat_dim: int = 1024
    max_len: int = 5000

    @property
    def num_tokens(self) -> int:
        """The sequence the layers see, CLS excluded: the object feature, its
        4 coordinate tokens, 4 per hand box and one per hand pose."""
        n_hand = 2 * self.num_steps
        return ((self.object_feat_dim > 0) + 4 * (self.emb_steps_object > 0)
                + 4 * n_hand * (self.emb_steps_hand > 0) + n_hand * (self.hand_feat_dim > 0))


class CoordMLP(nn.Module):
    def __init__(self, nin: int, feat_dim: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(nin, feat_dim)
        self.fc2 = nn.Linear(feat_dim, feat_dim)
        self.dtype = dtype

    def forward(self, x):
        return linear(F.silu(linear(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class TTCPredictionHead(nn.Module):
    def __init__(self, cfg: TTCHeadConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.feat_dim
        self.register_buffer("table", torch.from_numpy(sin1d_table(cfg.max_len, d)), persistent=False)
        if cfg.object_feat_dim > 0:
            self.object_feat_embedder = nn.Linear(cfg.object_feat_dim, d)
        for n in ("x0", "y0", "x1", "y1"):
            setattr(self, f"{n}_type_enc", nn.Parameter(torch.randn(1, d)))
        self.hand_side_enc = nn.Parameter(torch.randn(2, d))
        if cfg.emb_steps_object > 0:
            self.object_box_embedder = CoordMLP(d, d, dtype)
        if cfg.emb_steps_hand > 0:
            self.hand_box_embedder = CoordMLP(d, d, dtype)
        if cfg.hand_feat_dim > 0:
            self.hand_pose_embedder = CoordMLP(cfg.hand_feat_dim, d, dtype)
        if cfg.num_layers > 0:
            self.cls_token = nn.Parameter(torch.randn(1, d))
            self.layers = nn.ModuleList([
                EncoderLayer(d, cfg.num_heads, cfg.ff_dim / d, dtype, False, cfg.dropout, "relu")
                for _ in range(cfg.num_layers)])
            self.ttc_out = nn.Linear(d, 1)
        else:
            self.ttc_out = nn.Linear(cfg.num_tokens * d, 1)

    def forward(self, inputs: dict, rng=None):
        """inputs: box_features [N, Do], object_boxes [N, 1, 4] (normalized),
        hand_boxes [N, 2 * steps, 4] (normalized), hand_poses [N, 2 * steps,
        63]. Returns the softplus TTC [N]."""
        cfg, dt = self.cfg, self.dtype
        pe = self.table.to(dt)

        def quantized_coord_tokens(boxes, steps, mlp):
            idx = torch.clamp(torch.floor(boxes * steps).to(torch.int64), 0, cfg.max_len - 1)
            return mlp(pe[idx.reshape(idx.shape[0], -1)])  # [N, T * 4, D]

        tokens = []
        bsz = inputs["box_features"].shape[0]
        if cfg.object_feat_dim > 0:
            tokens.append(linear(inputs["box_features"].to(dt), self.object_feat_embedder, dt)[:, None])
        type_enc = torch.cat([getattr(self, f"{n}_type_enc") for n in ("x0", "y0", "x1", "y1")]).to(dt)
        side_enc = self.hand_side_enc.to(dt)
        steps_pe = pe[cfg.emb_steps_hand: cfg.emb_steps_hand + cfg.num_steps]
        if cfg.emb_steps_object > 0:
            ob = quantized_coord_tokens(inputs["object_boxes"], cfg.emb_steps_object, self.object_box_embedder)
            tokens.append(ob + type_enc.repeat(ob.shape[1] // 4, 1)[None])
        if cfg.emb_steps_hand > 0 and "hand_boxes" in inputs:
            hb = quantized_coord_tokens(inputs["hand_boxes"], cfg.emb_steps_hand, self.hand_box_embedder)
            n_tok = hb.shape[1]
            hb = (hb + side_enc.repeat_interleave(n_tok // 2, 0)[None]
                  + type_enc.repeat(n_tok // 4, 1)[None])
            # Temporal step encodings, repeated over the 4 coords per step.
            hb = hb + steps_pe.repeat_interleave(4, 0).repeat(2, 1)[None, :n_tok]
            tokens.append(hb)
        if cfg.hand_feat_dim > 0 and "hand_poses" in inputs:
            hp = self.hand_pose_embedder(inputs["hand_poses"].to(dt))
            n_tok = hp.shape[1]
            hp = hp + side_enc.repeat_interleave(n_tok // 2, 0)[None]
            tokens.append(hp + steps_pe.repeat(2, 1)[None, :n_tok])
        x = torch.cat(tokens, 1)
        if cfg.num_layers > 0:
            x = torch.cat([self.cls_token.to(dt)[None].expand(bsz, -1, -1), x], 1)
            for layer in self.layers:
                x = layer(x, rng=rng)
            pre = linear(x[:, 0], self.ttc_out, dt)[:, 0]
        else:
            pre = linear(F.gelu(x.reshape(bsz, -1)), self.ttc_out, dt)[:, 0]
        return F.softplus(pre)
