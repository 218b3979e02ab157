"""Model configuration for the PyTorch port of K3M.

Same JSON key surface and defaults as the reference config
(`configs/bert_base_6layer_6conect.json`; reference `BertConfig`,
vilbert_k3m/vilbert_k3m.py:149-308), so existing config files load
verbatim. A frozen dataclass: modules read it, nothing mutates it.

Fields that select TPU-only levers (`use_pallas`, `use_pallas_ln`, `remat`)
are accepted for file compatibility; the port always runs its own kernels on
a CUDA device and their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class K3MConfig:
    # --- text stream (BERT) ---
    vocab_size: int = 21128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02

    # --- visual stream ---
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 1024
    v_num_hidden_layers: int = 6
    v_num_attention_heads: int = 8
    v_intermediate_size: int = 1024
    v_attention_probs_dropout_prob: float = 0.1
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.1
    v_initializer_range: float = 0.2

    # --- cross-stream (co-attention) ---
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 8
    bi_intermediate_size: int = 1024
    bi_attention_type: int = 1    # dead key in the reference JSON; accepted
    v_biattention_id: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Tuple[int, ...] = (6, 7, 8, 9, 10, 11)

    # --- behaviour switches ---
    visual_target: int = 0        # 0: KLDiv vs soft labels, 1: MSE, 2: NCE
    fast_mode: bool = False
    fixed_v_layer: int = 0
    fixed_t_layer: int = 0
    in_batch_pairs: bool = False
    fusion_method: str = "mul"    # dead in the reference too; accepted
    dynamic_attention: bool = False
    with_coattention: bool = True
    objective: int = 0
    num_negative_image: int = 128
    num_negative_pv: int = 4
    margin: float = 1.0
    model: str = "bert"           # "bert" | "roberta" (position-id offset)
    task_specific_tokens: bool = False
    visualization: bool = False
    use_image: bool = True
    if_pre_sampling: int = 1      # 0 mean / 1 gumbel-hard / 2 soft / 3 interactive-only
    loss_type: str = "inner"      # item-alignment: "inner" | "cosine" | "ce"

    # --- extensions of the JAX package (absent in the reference) ---
    dtype: str = "float32"        # compute dtype: "float32" | "bfloat16"
    use_pallas: bool = False      # TPU lever; accepted, not read by the port
    use_pallas_ln: bool = True    # TPU lever; accepted, not read by the port
    fix_reference_bugs: bool = False
    remat: bool = True            # TPU lever; accepted, not read by the port
    packed_passes: bool = False   # run the three passes in one schedule: each
                                  # text layer once over the packed rows of
                                  # the four text streams, the image stack
                                  # once at 2B rows (model/encoder.py); the
                                  # same math, other dropout draws; bypassed
                                  # under in_batch_pairs and fast_mode
    ce_chunk: int = 64
    shared_prefix: bool = False   # run text layers [0, t_biattention_id[0])
                                  # once per stream instead of once per pass
    fused_qkv: bool = False       # each attention site's Q/K/V (each co-
                                  # attention stream's three) as one
                                  # projection over the concatenated weights
                                  # (model/layers.py fused_dense); the same
                                  # math and state dict

    def __post_init__(self):
        if len(self.v_biattention_id) != len(self.t_biattention_id):
            raise ValueError("v_biattention_id and t_biattention_id must have equal length")
        if max(self.v_biattention_id) >= self.v_num_hidden_layers:
            raise ValueError("v_biattention_id out of range")
        if max(self.t_biattention_id) >= self.num_hidden_layers:
            raise ValueError("t_biattention_id out of range")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size % num_attention_heads != 0")
        if self.v_hidden_size % self.v_num_attention_heads:
            raise ValueError("v_hidden_size % v_num_attention_heads != 0")
        if self.bi_hidden_size % self.bi_num_attention_heads:
            raise ValueError("bi_hidden_size % bi_num_attention_heads != 0")
        if self.visualization and self.use_pallas:
            raise ValueError(
                "visualization=True needs the unfused attention path "
                "(set use_pallas=False to collect attention probs)")

    # ------------------------------------------------------------------ io

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "K3MConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        clean: Dict[str, Any] = {}
        for k, v in d.items():
            if k == "vocab_size_or_config_json_file":
                k = "vocab_size"
            if k not in fields:
                continue  # ignore unknown keys, like the reference's from_dict
            if isinstance(v, list):
                v = tuple(v)
            clean[k] = v
        return cls(**clean)

    @classmethod
    def from_json_file(cls, path: str) -> "K3MConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, tuple):
                d[k] = list(v)
        return d

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def replace(self, **kw) -> "K3MConfig":
        for key in ("v_biattention_id", "t_biattention_id"):
            if key in kw and isinstance(kw[key], list):
                kw[key] = tuple(kw[key])
        return dataclasses.replace(self, **kw)

    @property
    def num_coattention_layers(self) -> int:
        return len(self.v_biattention_id)
