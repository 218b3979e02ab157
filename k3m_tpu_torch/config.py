"""Model configuration for the PyTorch port of K3M.

Same JSON key surface and defaults as the reference config
(`configs/bert_base_6layer_6conect.json`; reference `BertConfig`,
vilbert_k3m/vilbert_k3m.py:149-308), so existing config files load
verbatim. A frozen dataclass: modules read it, nothing mutates it.

Fields that select TPU-only levers (`use_pallas`, `use_pallas_ln`, `remat`)
are accepted for file compatibility; the port always runs its own kernels on
a CUDA device and their plain versions on the CPU.

`text_block` selects the text layer: "bert" (the default: BERT's post-LN
layer, model/layers.py TextLayer, every existing config) or "deepseek_v2"
(DeepSeek-V2's pre-norm layer of latent attention and a routed,
shared-expert MoE, model/deepseek.py), whose keys carry DeepSeek-V2's
published names (its config.json) and whose `experts_held` is the range of
routed experts this process holds (all of them by default).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


# DeepSeek-V2's keys whose one value model/deepseek.py builds (no q-LoRA,
# softmax scores, greedy top-k without renormalisation, groups or scaling,
# the sequence-wise balance loss, no attention bias, every layer past the
# dense ones MoE); a config file that states another value is refused
DEEPSEEK_FIXED = dict(q_lora_rank=None, scoring_func="softmax", topk_method="greedy",
                      norm_topk_prob=False, n_group=1, topk_group=1, routed_scaling_factor=1,
                      seq_aux=True, attention_bias=False, moe_layer_freq=1)


# the text-block selector and DeepSeek-V2's keys: a BERT config's dict form
# leaves them out (`to_dict`)
TEXT_BLOCK_KEYS = ("text_block", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                   "v_head_dim", "rope_theta", "rope_scaling", "rms_norm_eps",
                   "moe_intermediate_size", "n_routed_experts", "n_shared_experts",
                   "num_experts_per_tok", "first_k_dense_replace", "aux_loss_alpha",
                   "experts_held")


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

    # --- the text block (module docstring) ---
    text_block: str = "bert"      # "bert" | "deepseek_v2"
    # DeepSeek-V2's keys (read where text_block is "deepseek_v2")
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None   # YaRN's keys, or None
    rms_norm_eps: float = 1e-6
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64    # the router's outputs, all experts
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    aux_loss_alpha: float = 0.001
    experts_held: Tuple[int, ...] = ()   # [first, end) of the routed experts held
                                         # here; () holds every one

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
        if self.text_block not in ("bert", "deepseek_v2"):
            raise ValueError(f"text_block {self.text_block!r} is not 'bert' or 'deepseek_v2'")
        if self.text_block == "deepseek_v2":
            self._check_deepseek()

    def _check_deepseek(self):
        """A held range inside the routed experts, a top-k within them,
        YaRN's rope scaling or none, no visualization."""
        held = self.held_experts
        bad = dict(visualization=self.visualization,
                   experts_held=not 0 <= held[0] < held[1] <= self.n_routed_experts,
                   num_experts_per_tok=not 0 < self.num_experts_per_tok
                   <= self.n_routed_experts,
                   rope_scaling=self.rope_scaling is not None
                   and self.rope_scaling.get("type") != "yarn")
        bad = [k for k, v in bad.items() if v]
        if bad:
            raise ValueError(f"text_block 'deepseek_v2' does not build {bad}")

    # ------------------------------------------------------------------ io

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "K3MConfig":
        if d.get("text_block") == "deepseek_v2":
            fixed = {k: d[k] for k in DEEPSEEK_FIXED if k in d and d[k] != DEEPSEEK_FIXED[k]}
            if fixed:
                raise ValueError(f"text_block 'deepseek_v2' builds {DEEPSEEK_FIXED}, not "
                                 f"{fixed}")
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
        """The fields as JSON values; under the BERT text block without the
        text-block keys, so that its configs read and write as before them."""
        d = dataclasses.asdict(self)
        if self.text_block == "bert":
            for k in TEXT_BLOCK_KEYS:
                del d[k]
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

    @property
    def held_experts(self) -> Tuple[int, int]:
        """[first, end) of the routed experts this process holds."""
        return tuple(self.experts_held) if self.experts_held else (0, self.n_routed_experts)

