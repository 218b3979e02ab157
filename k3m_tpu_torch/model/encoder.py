"""Tri-stream K3M encoder.

Port of k3m_tpu/model/encoder.py (reference BertEncoder,
vilbert_k3m/vilbert_k3m.py:1114-1750). Three pairwise dual-stream passes
share the text and image layer stacks:
  1. t <-> v  : text + image layers + `c_layer`
  2. pv <-> v : the same text/image layers + `c_layer_pv_v`
  3. t <-> pv : text layers on both sides + `c_layer_pv_t`
Before co-attention block k, text runs layers [t_start, t_biattention_id[k])
and image runs [v_start, v_biattention_id[k]); trailing layers run after the
last block. `fixed_t/v_layer` freeze the first text/image layers in
training: their outputs are detached, the JAX package's stop_gradient
(encoder.py:77-104).
"""

from __future__ import annotations

from torch import nn

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model.coattention import ConnectionLayer, ConnectionLayerTwoText
from k3m_tpu_torch.model.layers import ImageLayer, TextLayer


class TriStreamEncoder(nn.Module):
    def __init__(self, cfg: K3MConfig):
        super().__init__()
        for flag in ("packed_passes", "fused_qkv", "in_batch_pairs", "fast_mode",
                     "visualization"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"{flag} is not ported yet")
        self.cfg = cfg
        n_co = cfg.num_coattention_layers
        self.layer = nn.ModuleList(TextLayer(cfg) for _ in range(cfg.num_hidden_layers))
        if cfg.use_image:
            self.v_layer = nn.ModuleList(
                ImageLayer(cfg) for _ in range(cfg.v_num_hidden_layers))
            if cfg.with_coattention:
                self.c_layer = nn.ModuleList(ConnectionLayer(cfg) for _ in range(n_co))
                self.c_layer_pv_v = nn.ModuleList(
                    ConnectionLayer(cfg) for _ in range(n_co))
        if cfg.with_coattention:
            self.c_layer_pv_t = nn.ModuleList(
                ConnectionLayerTwoText(cfg) for _ in range(n_co))

    def _run_text(self, x, bias, start: int, end: int, det: bool):
        for idx in range(start, end):
            x = self.layer[idx](x, bias, det)
            if idx < self.cfg.fixed_t_layer:
                x = x.detach()
        return x

    def _run_image(self, x, bias, txt, txt_mask2, start: int, end: int, det: bool):
        for idx in range(start, end):
            x = self.v_layer[idx](x, bias, txt, txt_mask2, det)
            if idx < self.cfg.fixed_v_layer:
                x = x.detach()
        return x

    def _pass_text_image(self, txt, img, txt_bias, txt_mask2, img_bias,
                         c_layers, det: bool, t_start: int = 0):
        """calculate_for_text_img / calculate_for_pv_img. `t_start` > 0
        means `txt` already went through text layers [0, t_start)."""
        cfg = self.cfg
        v_start = 0
        for count, (v_end, t_end) in enumerate(
                zip(cfg.v_biattention_id, cfg.t_biattention_id)):
            txt = self._run_text(txt, txt_bias, t_start, t_end, det)
            img = self._run_image(img, img_bias, txt, txt_mask2, v_start, v_end, det)
            if cfg.with_coattention:
                img, txt = c_layers[count](img, img_bias, txt, txt_bias, det)
            v_start, t_start = v_end, t_end
        img = self._run_image(img, img_bias, txt, txt_mask2, v_start,
                              cfg.v_num_hidden_layers, det)
        txt = self._run_text(txt, txt_bias, t_start, cfg.num_hidden_layers, det)
        return txt, img

    def _pass_two_text(self, txt, pv, txt_bias, pv_bias, det: bool, start: int = 0):
        """calculate_for_two_text: pv runs on the text stack; the schedule
        zips t_biattention_id with itself (ref :1534)."""
        cfg = self.cfg
        v_start = t_start = start
        for count, t_end in enumerate(cfg.t_biattention_id):
            txt = self._run_text(txt, txt_bias, t_start, t_end, det)
            pv = self._run_text(pv, pv_bias, v_start, t_end, det)
            if cfg.with_coattention:
                pv, txt = self.c_layer_pv_t[count](pv, pv_bias, txt, txt_bias, det)
            v_start = t_start = t_end
        pv = self._run_text(pv, pv_bias, v_start, cfg.num_hidden_layers, det)
        txt = self._run_text(txt, txt_bias, t_start, cfg.num_hidden_layers, det)
        return txt, pv

    def forward(self, txt_emb, img_emb, txt_bias, txt_mask2, img_bias,
                pv_emb, pv_bias, pv_mask2, deterministic: bool = True):
        """Returns (t_with_v, v_with_t, pv_with_v, v_with_pv, t_with_pv,
        pv_with_t); the first four are None when use_image=False."""
        cfg = self.cfg
        det = deterministic
        # shared_prefix: text layers [0, t_biattention_id[0]) see no
        # co-attention in any pass, so each stream's prefix is computed once
        pre = 0
        if cfg.shared_prefix and cfg.with_coattention:
            pre = cfg.t_biattention_id[0]
            txt_emb = self._run_text(txt_emb, txt_bias, 0, pre, det)
            pv_emb = self._run_text(pv_emb, pv_bias, 0, pre, det)
        if cfg.use_image:
            co = cfg.with_coattention
            t_with_v, v_with_t = self._pass_text_image(
                txt_emb, img_emb, txt_bias, txt_mask2, img_bias,
                self.c_layer if co else None, det, t_start=pre)
            pv_with_v, v_with_pv = self._pass_text_image(
                pv_emb, img_emb, pv_bias, pv_mask2, img_bias,
                self.c_layer_pv_v if co else None, det, t_start=pre)
        else:
            t_with_v = v_with_t = pv_with_v = v_with_pv = None
        t_with_pv, pv_with_t = self._pass_two_text(txt_emb, pv_emb, txt_bias,
                                                   pv_bias, det, start=pre)
        return t_with_v, v_with_t, pv_with_v, v_with_pv, t_with_pv, pv_with_t
