"""Typed configuration schema: the port's copy of
``tubelet_transformer_tpu/config.py``, field for field, so that one YAML
file configures both packages.

The reference uses an open-ended yacs tree (``pipelines/video_action_recognition_config.py``)
where experiment YAMLs inject many undeclared keys. Here every knob is a typed
dataclass field; ``load_config`` accepts the reference's YAML files verbatim
(``configuration/TubeR_CSN152_AVA22.yaml`` etc.) and maps them onto the schema,
so existing experiment configs keep working.

Reference key surface: the reference's configuration/TubeR_CSN152_AVA22.yaml
and its yacs defaults at pipelines/video_action_recognition_config.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TrainConfig:
    epoch_num: int = 20
    start_epoch: int = 0
    batch_size: int = 2              # per-host batch size
    lr: float = 1e-4
    min_lr: float = 1e-5
    lr_backbone: float = 1e-5
    momentum: float = 0.9
    w_decay: float = 1e-4
    lr_policy: str = "step"          # 'step' | 'cosine' | 'linear'
    use_warmup: bool = False
    warmup_start_lr: float = 1e-5
    warmup_epochs: int = 4
    lr_milestone: List[int] = field(default_factory=lambda: [10, 15])
    step: float = 0.1
    optimizer_name: str = "ADAMW"    # reference entry points always build AdamW
    aux_loss: bool = True
    seed: int = 0
    # Gradient accumulation: split each batch into this many microbatches
    # inside the jitted step (lax.scan), averaging gradients — the
    # effective batch is BATCH_SIZE with the activation memory of
    # BATCH_SIZE/ACCUM_STEPS. Semantics match the reference's multi-GPU
    # DDP averaging (per-microbatch criterion normalization, BN stats
    # updated sequentially like smaller batches).
    accum_steps: int = 1
    # Activation rematerialization for full-backprop training: each CSN
    # bottleneck recomputes its activations in the backward instead of
    # keeping them (jax.checkpoint), trading ~1/3 extra forward FLOPs for
    # a large cut in peak HBM — enables bigger batches when not using the
    # frozen-backbone recipe. No numerical change.
    remat_backbone: bool = False
    # Run the FROZEN backbone prefix (stem + stages up to the tune_point
    # boundary) as a lax.scan over FROZEN_CHUNK-sized batch chunks inside
    # the train step. The conv emitter's small-batch kernels are 2.5-3.3x
    # faster per clip than its bs>=4 kernels (BASELINE.md "Batch
    # scaling"), and the frozen prefix is pure forward — this is the
    # train-side sibling of MODEL.INFER_CHUNK. BN semantics: per-chunk
    # batch statistics with sequential EMA running-stat updates — the
    # reference recipe's unsynced per-GPU BatchNorm3d at per-GPU batch =
    # FROZEN_CHUNK (its shipped configs train DDP at BATCH_SIZE 2/GPU).
    # 0 disables (whole-batch statistics, single EMA update).
    frozen_chunk: int = 0


@dataclass
class ValConfig:
    batch_size: int = 1
    freq: int = 2
    put_gt: bool = False
    # Compute criterion losses during validation (the reference logs them,
    # video_action_recognition.py:303-305). mAP needs only the postprocess;
    # turning this off roughly halves eval-step cost (the 6 aux-layer
    # matchings + loss terms are ~10 ms of the 28 ms bs=4 eval step).
    compute_losses: bool = True
    # Size-banded person-AP breakdown: [[min_area, max_area], ...] in px^2.
    # Empty -> only the default 0..555^2 window (the reference's
    # STDetectionEvaluaterSinglePerson default, evaluate_ava.py:187-188;
    # the size-window family is its threshold_size_min/max parameters).
    person_size_bands: tuple = ()


@dataclass
class DataConfig:
    dataset_name: str = "ava"        # 'ava' | 'jhmdb' | 'ucf'
    label_path: str = ""
    anno_path: str = ""
    # AVA 2.1 excluded-timestamps CSV ("vid,ssss" rows); keys are dropped
    # from GT and detections (the reference hardcodes this path,
    # evaluates/evaluate_ava.py:36). Empty = no exclusions.
    exclude_path: str = ""
    data_path: str = ""
    num_classes: int = 80
    img_size: int = 256
    img_reshape_size: int = 288
    temp_len: int = 32               # frames per clip
    frame_rate: int = 2              # temporal stride when sampling frames
    num_workers: int = 8
    # Static-shape discipline: per-sample ground-truth boxes are padded to
    # this many entries with a validity mask (the reference carries ragged
    # per-sample lists; XLA needs fixed shapes).
    max_boxes: int = 32
    # Sample count of the synthetic smoke dataset (tests / dry runs).
    synthetic_size: int = 64
    # Paired variant: EVERY clip carries exactly two fixed-size blobs
    # (left -> class 0, right -> class 1), with the TARGET ARRAY ORDER
    # randomized per sample. With QUERY_NUM=2 each query is matched every
    # step (gate-friendly) but only cost-based Hungarian assignment is
    # stable across the shuffled target order — an identity/permutation
    # matcher bug makes each query chase alternating sides and collapses
    # localization (the multi-query quality gate, tests/test_e2e.py).
    synthetic_pair: bool = False
    # Easy detection variant of the synthetic task (one fixed-size box,
    # left-or-right): quickly learnable end-to-end, used by the e2e
    # detection-quality gate (tests/test_e2e.py overfit test).
    synthetic_easy: bool = False
    # Static canvas override (0 = auto: (img_size, img_size*16/9) rounded).
    # The reference feeds variable aspect-preserving shapes; we pad to one
    # canvas for XLA. Set both to img_size for square-crop training.
    canvas_h: int = 0
    canvas_w: int = 0
    # Use the native (libjpeg, C++) decode+resize path when the shared
    # library is available; PIL otherwise. Native is ~3x faster with
    # bilinear resampling (PIL defaults to bicubic — negligible for
    # training, set False for bit-level eval parity runs).
    # Photometric preprocessing (HSV jitter + ImageNet normalize) on the
    # TPU inside the jitted step: the loader ships uint8 clips (4x smaller
    # transfer, ~5x less host CPU per clip). Geometric transforms stay on
    # the host. data/device_preprocess.py.
    device_preprocess: bool = True
    native_decode: bool = True
    # Packed-clip shards (data/packed.py): "" = decode JPEGs per sample;
    # a path (optionally with "{}" for the split) reads pre-decoded shards
    # written by ``cli.pack_data`` — removes JPEG decode from the hot path.
    packed_path: str = ""


@dataclass
class ModelConfig:
    single_frame: bool = True
    backbone_name: str = "CSN-152"   # 'CSN-152' | 'CSN-50'
    temporal_ds_strategy: str = "decode"   # 'avg' | 'max' | 'decode' | 'middle'
    last_stride: bool = False
    generate_lfb: bool = False
    name: str = "tuber"
    enc_layers: int = 6
    dec_layers: int = 6
    d_model: int = 256
    nhead: int = 8
    dim_feedforward: int = 2048
    query_num: int = 15
    normalize_before: bool = False
    dropout: float = 0.1
    # Batched inference as lax.map over fixed-size chunks (0 = off).
    # Measured on v5e (CSN-152 flagship, BASELINE.md "Batch scaling"): the
    # conv emitter's layer1/2 fusions are 2.5-3.3x slower at bs>=4 than at
    # bs=2, so running a batch-8 forward as four scanned bs=2 chunks is
    # 12-15% faster per clip (217.8 -> 243.7 clips/s). Throughput knob for
    # batched serving/eval; leaves latency of the single chunk unchanged.
    # 0 = off for the jitted eval step; the serving POOL defaults its own
    # chunk to 2 when this is 0 (serving.py StreamingDetectorPool) and
    # auto-disables chunking when the batch axis is mesh-sharded.
    infer_chunk: int = 0
    ds_rate: int = 8
    temp_len: int = 32
    sample_rate: int = 2
    pretrained: bool = False
    pretrain_backbone_dir: str = ""
    pretrain_transformer_dir: str = ""
    pretrained_path: str = ""
    load: bool = False
    load_fc: bool = True
    load_detr: bool = False
    tune_point: int = 4              # CSN stages frozen up to this point
    # Sparse Mixture-of-Experts encoder FFN (models/moe.py): number of
    # experts (0 = dense FFN, the reference architecture), tokens routed
    # top-k with a fixed capacity. Expert kernels shard over the mesh
    # 'model' axis (expert parallelism) — a TPU-native capacity extension.
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    # TPU-specific: computation dtype of the hot path (params stay fp32).
    compute_dtype: str = "bfloat16"  # 'bfloat16' | 'float32'
    # Custom Pallas kernels on TPU (depthwise conv3d); XLA fallback elsewhere.
    # Default off: the v1 kernel matches XLA standalone but loses in-model
    # (XLA-side pad/reshape + broken fusion around pallas_call — measured
    # 145 -> 91 clips/s). Re-enable when the T-blocked fused version lands
    # (ROADMAP round-2 item 1).
    pallas_kernels: bool = False
    # Fused Pallas stem (conv 3x7x7 + BN + ReLU + max-pool in one kernel;
    # ~3.3x over the XLA chain at bs=4 — benchmarks/bench_stem.py). Applies
    # at inference on TPU for supported shapes; training/CPU use XLA.
    stem_kernel: bool = True
    # Fused stride-1 ir-bottleneck blocks (conv1x1+BN+ReLU+dw3x3x3+BN+ReLU+
    # conv1x1+BN+add+ReLU in one Pallas pass). Default OFF: wins standalone
    # parity but loses in-model (151 vs 214 clips/s measured — the
    # pallas_call fusion barrier + per-frame grid vs XLA's full-batch
    # matmuls; same lesson as the v1 depthwise kernel). Groundwork for a
    # T-blocked multi-frame version.
    fused_blocks: bool = False
    # Stage-chain kernels: the stride-1 identity tail of a CSN stage runs
    # as pipelined multi-block Pallas chains (one HBM read/write per chain,
    # mids and intermediate block outputs live in VMEM rings,
    # ops/pallas/stage.py). Default OFF — measured SLOWER than XLA (3.6 vs
    # 2.9 ms standalone at layer2 scale): XLA lowers depthwise convs
    # through a native TPU conv emitter that runs ~7x faster than pure VPU
    # tap FMAs (which pallas is limited to), so the chain's dw taps are the
    # wall. Kept as tested groundwork + documentation of the negative
    # result (see ROADMAP).
    fused_stages: bool = False


@dataclass
class MatcherConfig:
    cost_class: float = 12.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    bny_loss: bool = True
    before: bool = False


@dataclass
class LossConfig:
    mask_cof: float = 1.0
    dice_cof: float = 12.0           # multiplies loss_ce (naming kept from reference)
    bbox_cof: float = 5.0
    giou_cof: float = 2.0
    eos_cof: float = 0.1
    weight: float = 10.0             # per-matched-query BCE weight
    weight_change: int = 1000        # epoch after which loss_ce weight switches
    loss_change_cof: float = 2.0
    clips_max_norm: float = 0.1
    # Weight of the MoE load-balance auxiliary loss (Switch eq. 4), active
    # only when MODEL.MOE_EXPERTS > 0.
    moe_aux_cof: float = 0.01


@dataclass
class LogConfig:
    base_path: str = "runs"
    log_dir: str = "tb_log"
    save_dir: str = "checkpoints"
    eval_dir: str = "eval"
    exp_name: str = "tuber_tpu"
    save_freq: int = 1
    display_freq: int = 20
    res_dir: str = "tmp"
    # Capture a jax.profiler device trace of this many train steps (first
    # epoch, after the compile step) into <exp>/tb_log/profile; 0 = off.
    profile_steps: int = 0
    # Keep only the newest N committed checkpoints of this run (saves are
    # params + Adam moments, ~3x model size each); 0 = keep everything
    # (the reference's behavior).
    keep_ckpts: int = 0
    # Commit checkpoint saves on a background thread (orbax async): the
    # train loop resumes immediately instead of blocking on the host fetch
    # + disk write; the runner waits for in-flight saves before exiting.
    async_ckpt: bool = True


@dataclass
class MeshConfig:
    """Device-mesh layout. The reference supports data-parallel only (NCCL
    DDP, pipelines/launch.py); here the mesh is declarative and extensible."""
    data: int = -1                   # -1: all devices on the 'data' axis
    model: int = 1                   # tensor-parallel axis size (attention heads / FFN)
    # Pipeline parallelism: stages of the transformer encoder over the
    # 'pipe' mesh axis (GPipe microbatch schedule, parallel/pipeline.py).
    # ENC_LAYERS must divide by PIPE; the per-data-shard batch must divide
    # by PIPE_MICROBATCHES.
    pipe: int = 1
    pipe_microbatches: int = 2
    # Spatial (sequence) parallelism: shard the clip H axis over 'model'
    # for the backbone; GSPMD inserts collective-permute halo exchanges
    # for the 3D convs (verified bit-exact vs DP). A TPU-native capability
    # with no reference analog (SURVEY §5.7) — lets one clip span chips
    # when activations (268 MB/clip at layer1) exceed a single chip.
    spatial: bool = False
    # ZeRO stage 1: shard Adam moments over 'data' (largest divisible
    # axis); the moment update stays shard-local, one all-gather returns
    # the param delta. Cuts optimizer memory ~(1 - 1/n_data) x 2/3 of
    # the fp32 train-state bytes. SURVEY §2.8 strategy table, last row.
    zero1: bool = False


@dataclass
class LFBConfig:
    """Long-term feature bank knobs (companions of CONFIG.USE_LFB).

    The reference advertises the "+long-term context" capability but ships
    neither the bank nor its config (README.md:16-26); these are the knobs
    our implementation (eval/lfb.py) needs to feed the USE_LFB plumbing
    the reference's loops have (utils/video_action_recognition.py:109-139).
    """
    bank_path: str = ""        # .npz from ``cli.generate_lfb``
    half_window: int = 10      # seconds of context on each side of a keyframe


@dataclass
class Config:
    eval_only: bool = False
    two_stream: bool = False
    use_lfb: bool = False
    use_location: bool = False
    train: TrainConfig = field(default_factory=TrainConfig)
    val: ValConfig = field(default_factory=ValConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    log: LogConfig = field(default_factory=LogConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    lfb: LFBConfig = field(default_factory=LFBConfig)

    @property
    def num_queries_total(self) -> int:
        """Decoder query count: Q for AVA, Q * T' for tubelet (full) mode.

        Reference: models/tuber_ava.py:43-47.
        """
        if self.data.dataset_name == "ava":
            return self.model.query_num
        return self.model.query_num * self.model.temp_len

    @property
    def temporal_feat_len(self) -> int:
        """Feature frames after backbone temporal stride (T / DS_RATE), or 1
        when single-frame pooling is on. Reference: transformer.py:313."""
        if self.model.single_frame:
            return 1
        return self.model.temp_len // self.model.ds_rate


# ---------------------------------------------------------------------------
# YAML loading (reference-format compatible)
# ---------------------------------------------------------------------------

# Maps reference YAML keys (UPPER_SNAKE, nested under CONFIG) to schema paths.
_SECTION_MAP = {
    "TRAIN": "train",
    "VAL": "val",
    "DATA": "data",
    "MODEL": "model",
    "MATCHER": "matcher",
    "LOSS_COFS": "loss",
    "LOG": "log",
    "MESH": "mesh",
    "LFB": "lfb",
}

_KEY_RENAMES = {
    # (section, REFERENCE_KEY) -> field name; everything else is lower-cased.
    ("loss", "MASK_COF"): "mask_cof",
    ("loss", "DICE_COF"): "dice_cof",
    ("loss", "BBOX_COF"): "bbox_cof",
    ("loss", "GIOU_COF"): "giou_cof",
    ("loss", "EOS_COF"): "eos_cof",
    ("loss", "CLIPS_MAX_NORM"): "clips_max_norm",
    ("train", "W_DECAY"): "w_decay",
    ("log", "EXP_NAME"): "exp_name",
}

# Reference keys we accept but deliberately ignore (dead/unused there too, or
# replaced by the mesh abstraction).
_IGNORED_KEYS = {
    "MULTIGRID", "NUM_ENCODER_LAYERS", "IMG_RESHAPE_SIZE2", "GPU",
    "WORLD_SIZE", "WORLD_RANK", "GPU_WORLD_SIZE", "GPU_WORLD_RANK",
    "DIST_URL", "WOLRD_URLS", "AUTO_RANK_MATCH", "DIST_BACKEND",
    "DISTRIBUTED",
}


def _assign(obj: Any, key: str, value: Any, ctx: str) -> None:
    if not hasattr(obj, key):
        raise KeyError(f"unknown config key {ctx}.{key}")
    current = getattr(obj, key)
    if isinstance(current, bool):
        value = bool(value)
    elif isinstance(current, int) and not isinstance(value, bool):
        value = int(value)
    elif isinstance(current, float):
        value = float(value)
    setattr(obj, key, value)


def _merge_section(section_obj: Any, section_name: str, tree: Dict[str, Any]) -> None:
    for k, v in tree.items():
        if k in _IGNORED_KEYS:
            continue
        if k == "OPTIMIZER" and isinstance(v, dict):
            # reference: TRAIN.OPTIMIZER.NAME (train_tuber_ava.py builds AdamW
            # regardless; we honour the key).
            name = v.get("NAME")
            if name:
                section_obj.optimizer_name = str(name).upper()
            continue
        field_name = _KEY_RENAMES.get((section_name, k), k.lower())
        _assign(section_obj, field_name, v, section_name)


def merge_dict(cfg: Config, tree: Dict[str, Any]) -> Config:
    """Merge a (possibly reference-format) nested dict into a Config."""
    if "CONFIG" in tree or "DDP_CONFIG" in tree:
        # Reference layout: DDP_CONFIG ignored (mesh replaces it), CONFIG nested.
        tree = tree.get("CONFIG", {})
    for k, v in tree.items():
        if k in _IGNORED_KEYS:
            continue
        if k in _SECTION_MAP and isinstance(v, dict):
            _merge_section(getattr(cfg, _SECTION_MAP[k]), _SECTION_MAP[k], v)
        elif isinstance(v, dict) and hasattr(cfg, k.lower()):
            _merge_section(getattr(cfg, k.lower()), k.lower(), v)
        else:
            _assign(cfg, k.lower(), v, "CONFIG")
    return cfg


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Build a Config, optionally merging a YAML file and an override dict."""
    cfg = Config()
    if path is not None:
        import yaml

        with open(path) as f:
            tree = yaml.safe_load(f)
        merge_dict(cfg, tree or {})
    if overrides:
        merge_dict(cfg, overrides)
    return cfg


def to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
