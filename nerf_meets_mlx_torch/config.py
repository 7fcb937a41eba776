"""Typed configuration for the framework (PyTorch port).

A copy of ``nerf_meets_mlx_tpu/config.py``: the port imports nothing of the
JAX package, so it keeps its own presets, held equal to the JAX ones by
``tests/test_torch_config.py``. Comments that name TPU kernels describe the
JAX reference's routing; in the port ``use_fused_kernel`` routes the eval
render through the CUDA kernel of ``kernels/fused_train.py``.

Replaces the reference's argparse flag registry (~40 flags,
mlx_nerf/config_parser.py:3-80) and its `key = value` text
config overlay (config_parser.py:82-122) with frozen dataclasses plus named
presets for the five BASELINE.json configurations.

Reference quirks are explicit, opt-in switches rather than accidents:

* ``frequency_bands``: the reference's volume path uses *squared-linspace*
  frequency bands (``linspace(0, max)**2``, embedding.py:46-49) instead of the
  canonical ``2**linspace``.  ``"reference_squared"`` reproduces that exactly;
  ``"canonical"`` is the NeRF-paper behavior.
* ``compositing``: ``"reference"`` reproduces raw2outputs semantics at
  render.py:20-96 (no rgb sigmoid, relu only inside the alpha term, raw
  density in the transmittance cumsum); ``"canonical"`` applies
  sigmoid(rgb) / relu(density) before compositing (standard NeRF).
* The reference's `render_kwargs_test = render_kwargs_train` aliasing
  (models/NeRF.py:151-156) silently forced perturb=0 / noise=0 during
  training; here train and eval render settings are separate fields.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model / encoding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    """Configuration of one input encoding.

    kind:
      - "sinusoidal": NeRF positional encoding (encoding/sinusoidal.py:13-66
        in the reference, plus the legacy Embedder at models/embedding.py).
      - "identity":   pass-through (encoding/identity.py).
      - "spherical_harmonics": real SH basis deg 0..4
        (encoding/spherical_harmonics.py).
      - "hash_grid":  Instant-NGP multiresolution hash grid
        (encoding/multi_hash.py — fixed semantics, see encoding/hash_grid.py).
    """

    kind: str = "sinusoidal"
    in_dim: int = 3
    # sinusoidal
    n_freqs: int = 10
    min_freq_exp: float = 0.0
    max_freq_exp: Optional[float] = None  # default: n_freqs - 1
    include_input: bool = True
    # "canonical" -> 2**linspace ; "reference_squared" -> linspace**2
    # (reference volume path: models/embedding.py:46-49)
    frequency_bands: str = "canonical"
    # spherical harmonics
    sh_degree: int = 4
    # hash grid (Instant-NGP, Table 1 defaults)
    hash_n_levels: int = 16
    hash_min_res: int = 16
    hash_max_res: int = 512
    hash_features_per_level: int = 2
    hash_log2_table_size: int = 19
    hash_init_scale: float = 1e-4
    # GEMM operand dtype for the Pallas hash-encode fast path ("bfloat16"
    # rounds the looked-up table values to bf16 — the precision regime
    # INGP/tcnn train in; the XLA gather path always reads f32)
    hash_compute_dtype: str = "float32"
    # CP low-rank grid (TensoRF-style; encoding/cp_grid.py) — the TPU-native
    # fast neural field: 1-D factor lines interpolated via hat-matrix GEMMs,
    # zero gathers (the hash grid above is gather-bound on TPU)
    cp_n_levels: int = 4
    cp_min_res: int = 64
    cp_max_res: int = 512
    cp_n_components: int = 16
    cp_init_scale: float = 0.2

    @property
    def out_dim(self) -> int:
        if self.kind == "identity":
            return self.in_dim
        if self.kind == "sinusoidal":
            d = self.in_dim * self.n_freqs * 2
            if self.include_input:
                d += self.in_dim
            return d
        if self.kind == "spherical_harmonics":
            return (self.sh_degree + 1) ** 2
        if self.kind == "hash_grid":
            return self.hash_n_levels * self.hash_features_per_level
        if self.kind == "cp_grid":
            return self.cp_n_levels * self.cp_n_components
        raise ValueError(f"unknown encoding kind: {self.kind}")


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """NeRF MLP architecture (reference: models/NeRF.py:160-242).

    net_depth/net_width map to --netdepth/--netwidth (config_parser.py:13-16);
    skip connections concatenate the encoded position after the listed layer
    indices (reference hardcodes [4], models/NeRF.py:68).
    """

    net_depth: int = 8
    net_width: int = 256
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    # output channels when not using viewdirs (image-learning head,
    # models/NeRF.py:196-197)
    out_channels: int = 4
    # parameter/compute dtype for the matmul path ("float32" | "bfloat16")
    compute_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Volume rendering settings (reference: rendering/render.py)."""

    n_samples: int = 64          # --n_depth_samples
    n_importance: int = 128      # --N_importance
    perturb: float = 1.0         # stratified jitter strength (train)
    raw_noise_std: float = 0.0   # density regularization noise (train)
    white_bkgd: bool = True
    lindisp: bool = False
    ndc: bool = False
    near: float = 2.0
    far: float = 6.0
    # "reference" reproduces render.py:20-96 exactly; "canonical" applies
    # sigmoid(rgb) + the density activation below (standard NeRF compositing).
    compositing: str = "canonical"
    # canonical-mode density activation. "softplus" (default) keeps density
    # gradients alive everywhere — with "relu", an unlucky init can push all
    # raw densities negative within the first steps and the network dies
    # (observed: coarse net permanently stuck predicting pure background).
    # "relu" matches the original-NeRF/reference activation exactly.
    density_activation: str = "softplus"
    # eval-time chunk of rays per lax.map step (reference --chunk=32768)
    ray_chunk: int = 32768
    # scene AABB (xmin, ymin, zmin, xmax, ymax, zmax) for empty-space
    # skipping: per-ray slab intersection tightens [near, far] so the static
    # sample budget concentrates where geometry can be — the TPU analog of
    # occupancy-grid pruning (same quality at ~half the samples; dynamic
    # sample counts would break XLA's static shapes). None = reference
    # behavior (full [near, far] on every ray).
    aabb: Optional[Tuple[float, float, float, float, float, float]] = None
    # learned occupancy grid (acceleration/occupancy.py): density grid over
    # the AABB, EMA-updated from the fine network inside the train step,
    # probed per-ray to tighten [near, far] to actual geometry (beyond the
    # static slab test above). Requires aabb. Static shapes throughout —
    # only the sampling interval shrinks, never the sample count.
    occupancy: bool = False
    occ_resolution: int = 64
    occ_n_probes: int = 64       # per-ray grid probes (one gather each)
    occ_update_every: int = 16   # train steps between grid EMA updates
    occ_decay: float = 0.95      # EMA decay per update
    occ_threshold: float = 0.01  # activated-density occupancy cutoff
    occ_warmup: int = 1000       # steps before the grid gates sampling


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization settings (reference: config_parser.py:17-19,
    entrypoints/__test_nerf.py:302-305)."""

    n_rand: int = 4096           # rays per step (--N_rand)
    lrate: float = 5e-4
    lrate_decay: int = 250       # lr = lrate * 0.1**(step / (decay*1000))
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    # decoupled per-step L2 decay applied ONLY to learned-encoding params
    # (hash tables / CP lines) — high-capacity tables memorize sparse view
    # sets without it (engine/train_state.make_optimizer)
    encoding_weight_decay: float = 0.0
    max_iters: int = 200_000
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    # "replacement" (default: two randint draws, gather-cheap, ~50 duplicate
    # pixels per 4096-batch at 400^2) or "no_replacement" (reference parity:
    # np.random.choice(..., replace=False), __test_nerf.py:213-236 —
    # implemented as a top-k over per-pixel scores; costs a top_k over H*W)
    pixel_sampling: str = "replacement"
    seed: int = 0
    # logging / io cadences (reference flags config_parser.py:73-77)
    i_print: int = 100
    i_img: int = 500             # live-viewer render cadence (--i_img)
    i_weights: int = 10_000
    i_testset: int = 50_000
    i_video: int = 50_000
    log_dir: str = "./logs"
    exp_name: str = "exp"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset settings (reference: config_parser.py:51-68,
    dataset/dataloader.py)."""

    dataset_type: str = "blender"   # blender | llff | deepvoxels | synthetic | image
    data_dir: str = ""
    half_res: bool = False
    # "area" (2x2 box, the default) or "lanczos" (PIL Lanczos-3 per float
    # channel — the reference's exact half-res filter, dataloader.py:76-90;
    # needed for bit-level half-res fidelity comparisons)
    half_res_filter: str = "area"
    testskip: int = 8
    # LLFF forward-facing captures (reference has only the flags,
    # config_parser.py:58-71 — no loader): image downsample factor and the
    # every-k-th-image test split
    llff_factor: int = 8
    llffhold: int = 8
    # 360° inward-facing captures: re-frame about the view-axes' closest
    # point + circular render path (reference flag config_parser.py:62-63,
    # no implementation behind it). Implies ndc=False.
    spherify: bool = False
    # DeepVoxels object (reference flag --shape, config_parser.py:57:
    # armchair / cube / greek / vase)
    dv_shape: str = "greek"
    # procedural synthetic scene (for tests/benchmarks without downloads)
    synth_n_train: int = 20
    synth_n_val: int = 4
    synth_n_test: int = 4
    synth_resolution: int = 64
    # "blobs" (smooth Gaussians — gentle, for fast convergence tests) or
    # "hard" (sharp CSG geometry + occlusion + high-frequency texture —
    # the quality-benchmark scene; datasets/synthetic.py)
    synth_scene: str = "blobs"


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout. Rays are sharded along ``data``; model/hash params
    are replicated (their grads psum over the mesh). The reference is
    single-device (mlx_nerf/__main__.py:14) — this is the TPU-native upgrade."""

    data_axis: str = "data"
    # if 0: use all visible devices
    n_devices: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    pos_encoding: EncodingConfig = dataclasses.field(
        default_factory=lambda: EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=10)
    )
    dir_encoding: Optional[EncodingConfig] = dataclasses.field(
        default_factory=lambda: EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=4)
    )
    mlp: MLPConfig = dataclasses.field(default_factory=MLPConfig)
    mlp_fine: Optional[MLPConfig] = dataclasses.field(default_factory=MLPConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # route point queries through the fused Pallas encode+MLP kernel
    # (kernels/fused_mlp.py); requires sinusoidal pos+dir encodings and the
    # viewdir head. Off-TPU the kernel runs in interpreter mode, so tests
    # exercise identical code paths.
    use_fused_kernel: bool = False
    # when the fused kernel is on, additionally run TRAINING through the
    # one-launch forward+composite+loss-grad+backward kernel
    # (kernels/fused_train.py) — eliminates the duplicated forward of the
    # value_and_grad path. Ignored when use_fused_kernel is False.
    use_fused_train: bool = True

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Text-config compatibility (reference `key = value` format,
# config_parser.py:82-101; e.g. the NeRF-original configs/lego.txt)
# ---------------------------------------------------------------------------

_TRUTHY = {"true", "1", "yes"}


def parse_text_config(path: str | Path) -> dict:
    """Parse the NeRF-original ``key = value`` config format.

    Unlike the reference (which left every value a string — the stringly-typed
    bug at config_parser.py:104-122), values are coerced: int, float, bool,
    then str.
    """
    out: dict = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        for cast in (int, float):
            try:
                out[key] = cast(val)
                break
            except ValueError:
                continue
        else:
            if val.lower() in _TRUTHY or val.lower() in {"false", "no", "0"}:
                out[key] = val.lower() in _TRUTHY
            else:
                out[key] = val
    return out


def config_from_text(path: str | Path, base: Optional[ExperimentConfig] = None) -> ExperimentConfig:
    """Overlay a reference-format text config (e.g. lego.txt) onto a preset."""
    kv = parse_text_config(path)
    cfg = base if base is not None else lego_hierarchical()
    render = dataclasses.replace(
        cfg.render,
        # the reference renamed N_samples to --n_depth_samples
        # (config_parser.py:36); the NeRF-original text configs it loads
        # still say N_samples — accept both
        n_samples=int(
            kv.get("N_samples", kv.get("n_depth_samples", cfg.render.n_samples))
        ),
        n_importance=int(kv.get("N_importance", cfg.render.n_importance)),
        white_bkgd=bool(kv.get("white_bkgd", cfg.render.white_bkgd)),
        perturb=float(kv.get("perturb", cfg.render.perturb)),
        raw_noise_std=float(kv.get("raw_noise_std", cfg.render.raw_noise_std)),
        lindisp=bool(kv.get("lindisp", cfg.render.lindisp)),
        ndc=(not bool(kv["no_ndc"])) if "no_ndc" in kv else cfg.render.ndc,
        ray_chunk=int(kv.get("chunk", cfg.render.ray_chunk)),
        occupancy=bool(kv.get("occupancy", cfg.render.occupancy)),
        aabb=(
            tuple(float(v) for v in str(kv["aabb"]).split(","))
            if "aabb" in kv
            else cfg.render.aabb
        ),
    )
    train = dataclasses.replace(
        cfg.train,
        n_rand=int(kv.get("N_rand", cfg.train.n_rand)),
        lrate=float(kv.get("lrate", cfg.train.lrate)),
        lrate_decay=int(kv.get("lrate_decay", cfg.train.lrate_decay)),
        precrop_iters=int(kv.get("precrop_iters", cfg.train.precrop_iters)),
        precrop_frac=float(kv.get("precrop_frac", cfg.train.precrop_frac)),
        encoding_weight_decay=float(
            kv.get("encoding_weight_decay", cfg.train.encoding_weight_decay)
        ),
        exp_name=str(kv.get("expname", cfg.train.exp_name)),
        log_dir=str(kv.get("basedir", cfg.train.log_dir)),
        # logging/io cadences (reference config_parser.py:73-77)
        i_print=int(kv.get("i_print", cfg.train.i_print)),
        i_img=int(kv.get("i_img", cfg.train.i_img)),
        i_weights=int(kv.get("i_weights", cfg.train.i_weights)),
        i_testset=int(kv.get("i_testset", cfg.train.i_testset)),
        i_video=int(kv.get("i_video", cfg.train.i_video)),
    )
    data = dataclasses.replace(
        cfg.data,
        dataset_type=str(kv.get("dataset_type", cfg.data.dataset_type)),
        data_dir=str(kv.get("datadir", cfg.data.data_dir)),
        half_res=bool(kv.get("half_res", cfg.data.half_res)),
        testskip=int(kv.get("testskip", cfg.data.testskip)),
        llff_factor=int(kv.get("factor", cfg.data.llff_factor)),
        llffhold=int(kv.get("llffhold", cfg.data.llffhold)),
        spherify=bool(kv.get("spherify", cfg.data.spherify)),
        dv_shape=str(kv.get("shape", cfg.data.dv_shape)),
        synth_n_train=int(kv.get("synth_n_train", cfg.data.synth_n_train)),
        synth_scene=str(kv.get("synth_scene", cfg.data.synth_scene)),
    )
    # --netdepth/--netwidth(_fine) (reference config_parser.py:13-16);
    # --use_viewdirs (:38); --multires/--multires_views + --i_embed
    # (0 = positional, -1 = identity; :40-44)
    use_viewdirs = bool(kv.get("use_viewdirs", cfg.mlp.use_viewdirs))
    mlp = dataclasses.replace(
        cfg.mlp,
        net_depth=int(kv.get("netdepth", cfg.mlp.net_depth)),
        net_width=int(kv.get("netwidth", cfg.mlp.net_width)),
        use_viewdirs=use_viewdirs,
    )
    mlp_fine = cfg.mlp_fine
    if mlp_fine is not None:
        mlp_fine = dataclasses.replace(
            mlp_fine,
            net_depth=int(kv.get("netdepth_fine", mlp_fine.net_depth)),
            net_width=int(kv.get("netwidth_fine", mlp_fine.net_width)),
            use_viewdirs=use_viewdirs,
        )
    pos_enc, dir_enc = cfg.pos_encoding, cfg.dir_encoding
    if int(kv.get("i_embed", 0)) == -1:
        pos_enc = dataclasses.replace(pos_enc, kind="identity")
    elif "multires" in kv:
        pos_enc = dataclasses.replace(pos_enc, n_freqs=int(kv["multires"]))
    # hash-grid sizing overrides (our extension — the reference text format
    # predates its WIP hash encoding)
    hash_keys = {
        "hash_n_levels": int, "hash_min_res": int, "hash_max_res": int,
        "hash_features_per_level": int, "hash_log2_table_size": int,
        "hash_compute_dtype": str,
    }
    hash_kv = {k: cast(kv[k]) for k, cast in hash_keys.items() if k in kv}
    if hash_kv:
        pos_enc = dataclasses.replace(pos_enc, **hash_kv)
    if dir_enc is not None and "multires_views" in kv:
        dir_enc = dataclasses.replace(dir_enc, n_freqs=int(kv["multires_views"]))
    return cfg.replace(
        render=render, train=train, data=data, mlp=mlp, mlp_fine=mlp_fine,
        pos_encoding=pos_enc, dir_encoding=dir_enc,
    )


# ---------------------------------------------------------------------------
# Presets — the five BASELINE.json configurations
# ---------------------------------------------------------------------------


def image2d() -> ExperimentConfig:
    """Config 1: 2-D image learning.

    Matches entrypoints/__viser_image_learning.py:197-227 — 2-D sinusoidal
    encoding with 10 freqs / max_exp=8 / no include_input (40-D), non-viewdir
    MLP, Adam(1e-3, betas=(0.9, 0.99))."""
    return ExperimentConfig(
        pos_encoding=EncodingConfig(
            kind="sinusoidal", in_dim=2, n_freqs=10, max_freq_exp=8.0,
            include_input=False,
        ),
        dir_encoding=None,
        mlp=MLPConfig(use_viewdirs=False, out_channels=3),
        mlp_fine=None,
        render=RenderConfig(n_samples=0, n_importance=0),
        train=TrainConfig(lrate=1e-3, adam_b2=0.99, lrate_decay=0, max_iters=1000),
        data=DataConfig(dataset_type="image"),
    )


def _nerf_base(**render_kw) -> ExperimentConfig:
    return ExperimentConfig(
        pos_encoding=EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=10),
        dir_encoding=EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=4),
        mlp=MLPConfig(use_viewdirs=True),
        mlp_fine=MLPConfig(use_viewdirs=True),
        render=RenderConfig(**render_kw),
        # precrop 500 iters @ 0.5 matches the NeRF-original lego.txt the
        # reference trains with — and guards against the white-background
        # density-collapse local minimum (empirically init-dependent)
        train=TrainConfig(precrop_iters=500, precrop_frac=0.5),
        data=DataConfig(dataset_type="blender", half_res=True),
    )


def lego_coarse() -> ExperimentConfig:
    """Config 2: coarse-only NeRF, 400x400 (half-res), 64 samples/ray."""
    cfg = _nerf_base(n_samples=64, n_importance=0)
    return cfg.replace(mlp_fine=None)


def lego_hierarchical() -> ExperimentConfig:
    """Config 3: hierarchical coarse+fine, 64+128 samples/ray."""
    return _nerf_base(n_samples=64, n_importance=128)


def lego_fast() -> ExperimentConfig:
    """Hierarchical NeRF with AABB empty-space skipping at HALF the sample
    budget (32+64 vs 64+128): the slab-tightened [near, far] concentrates
    samples where geometry can be, holding test PSNR at ~2x the training
    throughput. Beyond-reference capability (the reference always marches
    the full near=2..far=6 span, render.py:134-140)."""
    cfg = _nerf_base(
        n_samples=32, n_importance=64,
        aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
    )
    return cfg


def lego_occ() -> ExperimentConfig:
    """lego_fast plus the LEARNED occupancy grid at HALF the reference
    sample budget (32+64 vs 64+128): the grid tightens each ray's interval
    to actual geometry (first/last occupied cell along the ray), so the
    remaining samples land almost entirely on the object. Beyond-reference
    capability stacked on lego_fast's static AABB skipping.

    Budget re-tuned on the hard benchmark scene (r3): the original quarter
    budget (16+32) lost 3.4 dB to the full-budget anchor there (blob-scene
    PSNR had hidden it); 32+64 matches the anchor (24.2 vs 24.4 dB @2k)."""
    cfg = _nerf_base(
        n_samples=32, n_importance=64,
        aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
        occupancy=True,
    )
    return cfg


def llff() -> ExperimentConfig:
    """LLFF forward-facing capture (fern-style): NDC rays (near=0, far=1 in
    NDC space), black background, no precrop, 64+64 samples/ray — the
    standard NeRF-LLFF recipe the reference exposes flags for but never
    implemented (config_parser.py:58-71)."""
    cfg = _nerf_base(
        n_samples=64, n_importance=64, ndc=True, near=0.0, far=1.0,
        white_bkgd=False,
    )
    return cfg.replace(
        train=dataclasses.replace(cfg.train, precrop_iters=0),
        data=DataConfig(dataset_type="llff"),
    )


def deepvoxels() -> ExperimentConfig:
    """DeepVoxels object capture (greek-style): the reference exposes
    --dataset_type deepvoxels and --shape (config_parser.py:53-57) with no
    loader; this preset pairs datasets/deepvoxels.py with the standard
    recipe — white background, hemisphere-derived near/far (set from the
    capture at load time), 64+128 samples, no precrop."""
    cfg = _nerf_base(n_samples=64, n_importance=128)
    return cfg.replace(
        train=dataclasses.replace(cfg.train, precrop_iters=0),
        data=DataConfig(dataset_type="deepvoxels"),
    )


def lego_full() -> ExperimentConfig:
    """Config 4: full 800x800, 200k iters with lr decay."""
    cfg = _nerf_base(n_samples=64, n_importance=128)
    return cfg.replace(data=dataclasses.replace(cfg.data, half_res=False))


def lego_ingp() -> ExperimentConfig:
    """Config 5: Instant-NGP hash-encoding variant, 5k-iter fast run.

    Sized from the r4 re-spec matrix (docs/results/ingp_respec.jsonl,
    hard scene, 5k iters, 50 views): T = 2^14 measured quality-IDENTICAL
    to 2^15 on this workload (26.33 vs 26.32 dB) at lower encode cost —
    the one-hot-GEMM kernel's table scan is 2*T*F FLOPs per lookup, so
    table size is a direct speed lever. 8 levels, 48+48 samples."""
    cfg = _nerf_base(n_samples=48, n_importance=48)
    return cfg.replace(
        pos_encoding=EncodingConfig(
            kind="hash_grid", in_dim=3, hash_n_levels=8, hash_max_res=256,
            hash_log2_table_size=14,
        ),
        dir_encoding=EncodingConfig(kind="spherical_harmonics", in_dim=3, sh_degree=4),
        mlp=MLPConfig(net_depth=2, net_width=64, skips=(), use_viewdirs=True),
        mlp_fine=MLPConfig(net_depth=2, net_width=64, skips=(), use_viewdirs=True),
        train=dataclasses.replace(
            cfg.train, max_iters=5000, lrate=1e-2, adam_b2=0.99,
            # the 2^15 x 8 x 2 tables memorize sparse view sets without
            # decay (hard scene, 20 views: train 28.7 / test 15.3 dB)
            encoding_weight_decay=1e-4,
        ),
    )


def lego_ingp_occ() -> ExperimentConfig:
    """lego_ingp plus the learned occupancy grid at a 32+32 sample budget —
    the INGP paper's own recipe (hash encoding + occupancy culling). The r4
    re-spec matrix measured 26.22 dB vs lego_ingp's 26.33 on the hard
    scene (5k iters, 50 views) while marching ~35% fewer points; this is
    the throughput-leaning hash preset (docs/results/ingp_respec.jsonl,
    tag t14_bf16_occ32)."""
    cfg = lego_ingp()
    return cfg.replace(
        render=dataclasses.replace(
            cfg.render, n_samples=32, n_importance=32, occupancy=True,
            aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
        ),
    )


def lego_cp() -> ExperimentConfig:
    """TPU-native fast-field variant: CP low-rank grid encoding (TensoRF-
    style, encoding/cp_grid.py) + SH directions + small MLP, 5k-iter fast
    run. Same capability class as Config 5's Instant-NGP (fast-converging
    learned spatial encoding, small MLP) but built from hat-matrix GEMMs
    instead of hash-table gathers — the design TPU hardware actually wants
    (the hash path is gather-bound, docs/DESIGN.md "Hash-grid on TPU")."""
    cfg = _nerf_base(
        n_samples=48, n_importance=48,
        aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
    )
    return cfg.replace(
        pos_encoding=EncodingConfig(kind="cp_grid", in_dim=3),
        dir_encoding=EncodingConfig(kind="spherical_harmonics", in_dim=3, sh_degree=4),
        mlp=MLPConfig(net_depth=2, net_width=64, skips=(), use_viewdirs=True),
        mlp_fine=MLPConfig(net_depth=2, net_width=64, skips=(), use_viewdirs=True),
        train=dataclasses.replace(cfg.train, max_iters=5000, lrate=1e-2, adam_b2=0.99),
    )


PRESETS = {
    "image2d": image2d,
    "lego_coarse": lego_coarse,
    "lego_hierarchical": lego_hierarchical,
    "lego_fast": lego_fast,
    "lego_occ": lego_occ,
    "lego_full": lego_full,
    "lego_ingp": lego_ingp,
    "lego_ingp_occ": lego_ingp_occ,
    "lego_cp": lego_cp,
    "llff": llff,
    "deepvoxels": deepvoxels,
}
