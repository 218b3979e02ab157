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

Two options change the rows after the first segment of the t<->v, pv<->v
and t<->pv passes (k3m_tpu/model/encoder.py:122-133, 155-166):
  * `in_batch_pairs`: the text side's rows repeat per item and the other
    stream's rows tile, so that row i * b + j pairs text i with image (or
    pv) j: b x b rows from there on (`pair_streams`; their dim-0 layout
    `dist.pair_rows`). The text mask that the image layers' dynamic
    attention pools with is not repeated, as in the JAX package (there it
    fails to broadcast past b = 1, and so it does here).
  * `fast_mode`: the text stream and its bias broadcast to the other
    stream's batch (a text batch of 1 against B images or pvs).
At the model level the fusion block concatenates the encoder's rows with
the embeddings' b rows and fails where they differ, in both packages.

`packed_passes` (k3m_tpu/model/encoder.py:178-254) runs the three passes
in one schedule where neither option above is set (encoder.py:264): the
four text streams [t, pv, t, pv] (t<->v's text, pv<->v's text, t<->pv's
two sides; [t, pv] without the image) go through each segment of the text
stack as one `Packed` set of rows, and the image stack runs once over
[img; img] at 2B rows (pass t<->v's image, then pass pv<->v's), gated,
under dynamic_attention, on the two passes' text padded to one length
and concatenated along the batch. The co-attention blocks take each
pass's streams apart as before. It ignores `shared_prefix`, as the JAX
package's does, and it runs the text layers after the last co-attention
block before the image layers after it (encoder.py:244-247), where the
sequential passes run those image layers first (:143-146): under
dynamic_attention they are gated on the text after the last text layer,
not before it, so there the packed schedule is the JAX package's packed
schedule, not its sequential passes. Its draws: the packed text rows'
hidden dropout bits are drawn with the batch on dim 0
(layers.packed_bits); the image stack's rows are two copies of the batch
(`dist.stacked`), copy h's row b numbered h * G + row0 + b among G global
rows, in its dropout bits and its attention masks (one kernel call for
both copies in a world of one data rank, one per copy under data
parallelism). So N data ranks draw, bit for bit, what one process draws
for the global batch; the draws differ from the sequential passes' (as
the JAX package's do).

The text stack is `config.text_block`'s: BERT's TextLayer, or DeepSeek-V2's
layers (model/deepseek.py), which take the same one stream or `Packed`
rows and after whose last layer every text stream's output goes through
the final RMSNorm `norm` once (in each pass, or once over the packed rows).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch import dist
from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model import deepseek
from k3m_tpu_torch.model.coattention import ConnectionLayer, ConnectionLayerTwoText
from k3m_tpu_torch.model.layers import ImageLayer, Packed, TextLayer, compute_dtype


def pair_streams(txt, txt_bias, other, other_bias):
    """The in_batch_pairs rows: text row i repeated once per row j of the
    other stream (`repeat_interleave`), the other stream tiled (`repeat`),
    so that row i * B + j pairs text i with row j. Under data parallelism
    the other stream is first gathered over the data groups (with its
    gradient), so that a rank's text rows meet every row of the global
    batch, as the JAX package's one global array pairs them."""
    world = dist.current()
    b = txt.shape[0]
    if other.shape[0] != b:
        raise ValueError(f"in_batch_pairs pairs each item's text with every item's other "
                         f"stream: {b} text rows against {other.shape[0]}")
    other, other_bias = world.gather_rows(other), world.all_gather_rows(other_bias)
    B = other.shape[0]
    tile = lambda t: t.repeat((b,) + (1,) * (t.dim() - 1))
    return (txt.repeat_interleave(B, dim=0), txt_bias.repeat_interleave(B, dim=0),
            tile(other), tile(other_bias))


def broadcast_text(txt, txt_bias, rows: int):
    """fast_mode: the text stream and its bias broadcast to `rows`. The
    text is made contiguous (the LayerNorm kernel reads a contiguous
    residual); the [B, Lk] bias stays an `expand`ed view with batch stride
    0, deliberately: the attention kernels read the bias row of batch b at
    `bias + b * bias_sb` (csrc/attention.cuh, attention_mma.cuh:115), so
    stride 0 gives every row the one text row's bias without a copy."""
    if txt.shape[0] == rows:
        return txt, txt_bias
    return (txt.expand((rows,) + tuple(txt.shape[1:])).contiguous(),
            txt_bias.expand((rows,) + tuple(txt_bias.shape[1:])))


class TriStreamEncoder(nn.Module):
    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.cfg = cfg
        n_co = cfg.num_coattention_layers
        if cfg.text_block == "deepseek_v2":
            self.layer = nn.ModuleList(deepseek.text_layers(cfg))
            self.norm = deepseek.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, compute_dtype(cfg))
        else:
            self.layer = nn.ModuleList(TextLayer(cfg) for _ in range(cfg.num_hidden_layers))
            self.norm = None
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
        if self.norm is not None and end == self.cfg.num_hidden_layers:
            x = self.norm(x)
        return x

    def _run_text_packed(self, xs, biases, start: int, end: int, det: bool):
        """Text layers [start, end) over the streams `xs` at once, as
        `Packed` rows (biases: one per stream); returns the streams, views
        of the last layer's rows."""
        last = self.norm is not None and end == self.cfg.num_hidden_layers
        if start == end and not last:
            return list(xs)
        p = Packed.pack(xs)
        for idx in range(start, end):
            p = self.layer[idx](p, biases, det)
            if idx < self.cfg.fixed_t_layer:
                p = Packed(p.rows.detach(), p.shapes)
        if last:
            p = Packed(self.norm(p.rows), p.shapes)
        return list(p.unpack())

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
        with contextlib.ExitStack() as rows:
            for count, (v_end, t_end) in enumerate(
                    zip(cfg.v_biattention_id, cfg.t_biattention_id)):
                txt = self._run_text(txt, txt_bias, t_start, t_end, det)
                img = self._run_image(img, img_bias, txt, txt_mask2, v_start, v_end, det)
                if count == 0:
                    txt, txt_bias, img, img_bias = self._first_segment_rows(
                        txt, txt_bias, img, img_bias, rows)
                if cfg.with_coattention:
                    img, txt = c_layers[count](img, img_bias, txt, txt_bias, det)
                v_start, t_start = v_end, t_end
            img = self._run_image(img, img_bias, txt, txt_mask2, v_start,
                                  cfg.v_num_hidden_layers, det)
            txt = self._run_text(txt, txt_bias, t_start, cfg.num_hidden_layers, det)
        return txt, img

    def _first_segment_rows(self, txt, txt_bias, other, other_bias, rows):
        """in_batch_pairs / fast_mode after the first segment of a pass; the
        pair rows stay the dim-0 layout (`rows`, an ExitStack) until the
        pass ends."""
        if self.cfg.in_batch_pairs:
            txt, txt_bias, other, other_bias = pair_streams(txt, txt_bias, other, other_bias)
            rows.enter_context(dist.pair_rows(txt.shape[0]))
        if self.cfg.fast_mode:
            txt, txt_bias = broadcast_text(txt, txt_bias, other.shape[0])
        return txt, txt_bias, other, other_bias

    def _pass_two_text(self, txt, pv, txt_bias, pv_bias, det: bool, start: int = 0):
        """calculate_for_two_text: pv runs on the text stack; the schedule
        zips t_biattention_id with itself (ref :1534)."""
        cfg = self.cfg
        v_start = t_start = start
        with contextlib.ExitStack() as rows:
            for count, t_end in enumerate(cfg.t_biattention_id):
                txt = self._run_text(txt, txt_bias, t_start, t_end, det)
                pv = self._run_text(pv, pv_bias, v_start, t_end, det)
                if count == 0:
                    txt, txt_bias, pv, pv_bias = self._first_segment_rows(
                        txt, txt_bias, pv, pv_bias, rows)
                if cfg.with_coattention:
                    pv, txt = self.c_layer_pv_t[count](pv, pv_bias, txt, txt_bias, det)
                v_start = t_start = t_end
            pv = self._run_text(pv, pv_bias, v_start, cfg.num_hidden_layers, det)
            txt = self._run_text(txt, txt_bias, t_start, cfg.num_hidden_layers, det)
        return txt, pv

    def _fused_passes(self, txt_emb, img_emb, txt_bias, txt_mask2, img_bias,
                      pv_emb, pv_bias, pv_mask2, det: bool):
        """The three passes in one schedule (packed_passes; module
        docstring): the sequential passes' outputs, but for the image
        layers' gates under dynamic_attention."""
        cfg = self.cfg
        use_img = cfg.use_image
        streams = [txt_emb, pv_emb, txt_emb, pv_emb] if use_img else [txt_emb, pv_emb]
        biases = (txt_bias, pv_bias) * (len(streams) // 2)
        if use_img:
            img2 = torch.cat([img_emb, img_emb])
            img_bias2 = torch.cat([img_bias, img_bias])

        def txt_gates():
            # each image copy gates on its own pass's current text (t, pv):
            # both padded to one length (the mask keeps the pooling exact)
            if not cfg.dynamic_attention:
                return None, None
            L = max(streams[0].shape[1], streams[1].shape[1])
            pad = lambda a: F.pad(a, (0, 0, 0, L - a.shape[1]))
            return (torch.cat([pad(streams[0]), pad(streams[1])]),
                    torch.cat([pad(txt_mask2), pad(pv_mask2)]))

        v_start = t_start = 0
        with dist.stacked(2):
            for count, (v_end, t_end) in enumerate(
                    zip(cfg.v_biattention_id, cfg.t_biattention_id)):
                streams = self._run_text_packed(streams, biases, t_start, t_end, det)
                if use_img:
                    img2 = self._run_image(img2, img_bias2, *txt_gates(), v_start, v_end, det)
                if cfg.with_coattention:
                    if use_img:
                        img_a, img_b = img2.chunk(2)
                        img_a, streams[0] = self.c_layer[count](
                            img_a, img_bias, streams[0], txt_bias, det)
                        img_b, streams[1] = self.c_layer_pv_v[count](
                            img_b, img_bias, streams[1], pv_bias, det)
                        img2 = torch.cat([img_a, img_b])
                        streams[3], streams[2] = self.c_layer_pv_t[count](
                            streams[3], pv_bias, streams[2], txt_bias, det)
                    else:
                        streams[1], streams[0] = self.c_layer_pv_t[count](
                            streams[1], pv_bias, streams[0], txt_bias, det)
                v_start, t_start = v_end, t_end
            streams = self._run_text_packed(streams, biases, t_start, cfg.num_hidden_layers,
                                            det)
            if not use_img:
                return None, None, None, None, streams[0], streams[1]
            img2 = self._run_image(img2, img_bias2, *txt_gates(), v_start,
                                   cfg.v_num_hidden_layers, det)
        v_with_t, v_with_pv = img2.chunk(2)
        return streams[0], v_with_t, streams[1], v_with_pv, streams[2], streams[3]

    def forward(self, txt_emb, img_emb, txt_bias, txt_mask2, img_bias,
                pv_emb, pv_bias, pv_mask2, deterministic: bool = True):
        """Returns (t_with_v, v_with_t, pv_with_v, v_with_pv, t_with_pv,
        pv_with_t); the first four are None when use_image=False."""
        cfg = self.cfg
        det = deterministic
        if cfg.packed_passes and not (cfg.in_batch_pairs or cfg.fast_mode):
            return self._fused_passes(txt_emb, img_emb, txt_bias, txt_mask2, img_bias,
                                      pv_emb, pv_bias, pv_mask2, det)
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
