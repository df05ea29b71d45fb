"""The port's raw-image serving path (fast3r_torch) against fast3r_tpu on
the CPU: the head's road at every view shape, the resize (K12's plain
version and gradient), loading and preprocessing, mixed-shape and profiled
inference, ``inference_from_raw`` and checkpoint loading.

Inputs are made from seeds with numpy.  The JAX resize kernel runs in
interpret mode; the JAX models draw their decoder image ids from
``jax.random.key(0)``, which the port takes as ``image_ids``.  Tolerances
are stated per test.
"""

import dataclasses
import importlib

import numpy as np
import PIL.Image
import pytest

import jax
import jax.numpy as jnp
import torch

from fast3r_torch.inference import Fast3R, inference, inference_from_raw
from fast3r_torch.models.dpt_head import head_road
from fast3r_torch.ops import preprocess as t_pre
from fast3r_torch.ops import resize as t_resize
from fast3r_torch.ops import resize_kernel as t_rk
from fast3r_torch.utils import checkpoint as t_ckpt
from fast3r_torch.utils import checkpoint_utils as t_cu
from fast3r_torch.utils import image as t_image

from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.ops import preprocess as j_pre
from fast3r_tpu.ops.resize import _resize_matmul
from fast3r_tpu.ops.resize_kernel import (
    resize_bilinear_kernel,
    resize_kernel_supported,
)
from fast3r_tpu.ops.trunk_kernel import trunk_kernel_supported
from fast3r_tpu.utils import checkpoint_utils as j_cu
from fast3r_tpu.utils import image as j_image

from test_torch_model import _jax_params, _port_cfg
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# the module (fast3r_tpu's package attribute of that name is the function)
j_inf = importlib.import_module("fast3r_tpu.inference")

# fp32 on both sides through the tiny model, differing in summation order
MODEL_TOL = dict(rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the head's road
# ---------------------------------------------------------------------------

def _head_shapes(kind):
    """The head shapes ``make_plan`` produces: at size 512 the long side is
    512 and the short side a multiple of 16; at 224 a 224 square."""
    shorts = range(160, 513, 16)
    if kind == "landscape":
        return [(h, 512) for h in shorts]
    if kind == "portrait":
        return [(512, w) for w in shorts]
    return [(224, 224)]


def _jax_road(H, W):
    if trunk_kernel_supported((1, H // 2, W // 2, 256), H, W, jnp.bfloat16,
                              c1=128, c3=4):
        return "trunk"
    if resize_kernel_supported((1, H // 2, W // 2, 128), H, W, jnp.bfloat16):
        return "resize_kernel"
    return "resize_matmul"


@pytest.mark.parametrize("kind", ["landscape", "portrait", "square224"])
def test_head_road_matches_jax(kind):
    """The port's trunk road (fused chain, unfused with K12, unfused with
    the matmul resize) equals the JAX head's at every shape, with the
    JAX resize gate's lane caps and row-plan checks included on its side."""
    roads = {}
    for H, W in _head_shapes(kind):
        got = head_road((1, 256, H // 2, W // 2), (H, W), 128, 128, 4,
                        torch.bfloat16)
        assert got == _jax_road(H, W), (H, W)
        roads[H, W] = got
        # float32 keeps the port's own fused chain
        assert head_road((1, 256, H // 2, W // 2), (H, W), 128, 128, 4,
                         torch.float32) == "trunk"
    if kind == "landscape":
        assert roads[448, 512] == roads[512, 512] == "resize_kernel"
        assert roads[256, 512] == roads[320, 512] == "resize_matmul"
        assert roads[384, 512] == "trunk"
    if kind == "portrait":
        assert roads[512, 496] == "resize_kernel"
        assert roads[512, 384] == "trunk"


def test_resize_gate_asks_for_a_band_plan():
    """K12's gate refuses a shape no band of the kernel fits (a 2 x 10^6
    source to 2 x 2: one output row spans the whole source row), so it
    takes resize_matmul instead of raising at launch; at every head shape
    of make_plan (23 landscape, 23 portrait at 512, the 224 square) the
    gate still equals JAX's."""
    assert not t_rk.resize_kernel_supported((1, 128, 2, 1_000_000), 2, 2,
                                            torch.bfloat16)
    with pytest.raises(ValueError, match="no band"):
        t_rk.band_plan(2, 1_000_000, 2, 2)
    shapes = [hw for kind in ("landscape", "portrait", "square224")
              for hw in _head_shapes(kind)]
    assert len(shapes) == 47
    for H, W in shapes:
        assert t_rk.resize_kernel_supported(
            (1, 128, H // 2, W // 2), H, W, torch.bfloat16) == \
            resize_kernel_supported((1, H // 2, W // 2, 128), H, W,
                                    jnp.bfloat16), (H, W)


# ---------------------------------------------------------------------------
# the resize (K12's plain version)
# ---------------------------------------------------------------------------

def _mk(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape,out_hw", [((2, 96, 128, 128), (192, 256)),
                                          ((1, 64, 32, 128), (96, 80))])
def test_resize_plain_matches_jax_kernel(shape, out_hw):
    """bf16: the port's plain version (and its CPU wrapper) against the
    JAX Pallas kernel in interpret mode, at atol = rtol = 0.03 as the JAX
    kernel's own test (the TPU kernel's W pass rounds after each bf16
    operation, the port's once)."""
    x = _mk(shape, 0)
    ref = np.asarray(resize_bilinear_kernel(jnp.asarray(x, jnp.bfloat16),
                                            *out_hw), np.float32)
    xt = _nchw(x).to(torch.bfloat16)
    for got in (t_resize.resize_matmul(xt, *out_hw),
                t_rk.resize_bilinear_kernel(xt, *out_hw)):
        got = got.float().permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, ref, atol=0.03, rtol=0.03)
    assert t_rk.resize_kernel_supported(xt.shape[:1] + (128,) + shape[1:3],
                                        *out_hw, torch.bfloat16) == \
        resize_kernel_supported(shape, *out_hw, jnp.bfloat16)


def test_resize_backward_matches_jax_vjp():
    """The CUDA autograd Function's backward (transposed matrices) and the
    CPU autograd of the plain version against jax.vjp of the Pallas kernel,
    bf16, within 0.05."""
    shape, out_hw = (1, 16, 32, 128), (32, 64)
    x, g = _mk(shape, 3), _mk((1, *out_hw, 128), 4)
    _, vjp = jax.vjp(lambda a: resize_bilinear_kernel(a, *out_hw),
                     jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0], np.float32)
    gt = _nchw(g).to(torch.bfloat16)
    got = t_rk._resize_bwd(gt, shape[1:3]).float().permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=0.05, rtol=0.05)
    xt = _nchw(x).to(torch.bfloat16).requires_grad_()
    t_rk.resize_bilinear_kernel(xt, *out_hw).backward(gt)
    np.testing.assert_allclose(xt.grad.float().permute(0, 2, 3, 1).numpy(),
                               ref, atol=0.05, rtol=0.05)


def test_resize_fp32_matches_matmul_form():
    """fp32: the plain version equals JAX's ``_resize_matmul`` within 1e-6
    (two fp32 products, summation order only)."""
    x = _mk((2, 24, 20, 8), 5)
    for out_hw in ((48, 40), (31, 17)):
        ref = np.asarray(_resize_matmul(jnp.asarray(x), *out_hw))
        got = t_resize.resize_matmul(_nchw(x), *out_hw).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# loading and preprocessing
# ---------------------------------------------------------------------------

def _photo(h, w, seed):
    """A smooth seeded photo (low-frequency content, as photos have)."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (max(2, h // 16), max(2, w // 16), 3))
    return np.asarray(PIL.Image.fromarray(small.astype(np.uint8)).resize(
        (w, h), PIL.Image.BICUBIC), np.uint8)


@pytest.mark.parametrize("size,square_ok", [(512, False), (512, True),
                                            (224, False)])
def test_make_plan_matches_jax(size, square_ok):
    for H0 in range(97, 1400, 151):
        for W0 in range(101, 1500, 173):
            for landscape in (False, True):
                args = ((H0, W0), size, square_ok, landscape)
                assert dataclasses.asdict(t_pre.make_plan(*args)) == \
                    dataclasses.asdict(j_pre.make_plan(*args)), args
    for hw in ((512, 512), (1008, 1152), (480, 640)):
        assert t_pre.make_plan(hw, size, square_ok) == \
            t_pre.PreprocessPlan(**dataclasses.asdict(
                j_pre.make_plan(hw, size, square_ok)))


def test_load_images_match_jax(tmp_path):
    """Seeded PNGs (and one with an EXIF rotation): the same views as
    fast3r_tpu's load_images / load_images_raw, image values within 1e-6
    (its normaliser may be a native kernel)."""
    shapes = [(120, 160), (160, 120), (150, 150), (100, 260)]
    for i, (h, w) in enumerate(shapes):
        PIL.Image.fromarray(_photo(h, w, i)).save(tmp_path / f"{i}.png")
    exif = PIL.Image.Exif()
    exif[0x0112] = 6  # rotate 90 on display
    PIL.Image.fromarray(_photo(90, 140, 9)).save(tmp_path / "r.jpg",
                                                 exif=exif, quality=95)
    (tmp_path / "notes.txt").write_text("skipped")
    for kw in (dict(size=512), dict(size=512, square_ok=True),
               dict(size=224), dict(size=128, crop_to_landscape=True)):
        got = t_image.load_images(str(tmp_path), verbose=False, **kw)
        ref = j_image.load_images(str(tmp_path), verbose=False, **kw)
        assert len(got) == len(ref) == 5
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a["true_shape"], b["true_shape"])
            assert (a["idx"], a["instance"]) == (b["idx"], b["instance"])
            np.testing.assert_allclose(a["img"], b["img"], atol=1e-6, rtol=0)
    for a, b in zip(t_image.load_images_raw(str(tmp_path), verbose=False),
                    j_image.load_images_raw(str(tmp_path), verbose=False)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src_hw,size,square_ok", [
    ((480, 640), 512, False), ((300, 200), 512, False),
    ((1008, 1152), 512, False), ((512, 512), 512, True),
    ((333, 517), 224, False)])
def test_preprocess_device_matches_jax(src_hw, size, square_ok):
    """Lanczos-3 down / Keys cubic (a = -0.5) up, as jax.image.resize: the
    two sides differ by fp32 summation order, which can move a value across
    a rounding tie: at most 2 uint8 steps anywhere, 99% of values exact."""
    raw = np.random.default_rng(0).integers(0, 256, (2, *src_hw, 3),
                                            dtype=np.uint8)
    plan = t_pre.make_plan(src_hw, size, square_ok)
    ref = np.asarray(j_pre.preprocess_device(
        jnp.asarray(raw), j_pre.make_plan(src_hw, size, square_ok)))
    got = t_pre.preprocess_device(torch.from_numpy(raw), plan).numpy()
    assert got.shape == ref.shape == (2, *plan.out_hw, 3)
    steps = np.abs(got - ref) * 127.5
    assert steps.max() <= 2 + 1e-3
    assert (steps < 1e-3).mean() >= 0.99


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

_TINY = {}


def _tiny():
    """(jax cfg, jax params, port model) of the tiny configuration."""
    if not _TINY:
        jcfg = jf.Fast3RConfig.tiny()
        params = _jax_params(jcfg, seed=1)
        tree = jax.tree.map(np.asarray, params)
        _TINY["m"] = (jcfg, params, Fast3R.from_jax_params(
            tree, _port_cfg(jcfg), device="cpu"))
    return _TINY["m"]


def _jax_ids(V):
    return np.asarray(sample_random_image_ids(jax.random.key(0), 1, V)[0])


def _assert_preds(got, ref, tol=MODEL_TOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(r[k]),
                                       err_msg=k, **tol)


def test_mixed_shape_inference_matches_jax():
    """Three shapes (a 3x5 patch grid among them), views interleaved: the
    port's grouped encoder, whole-sequence decoder and per-shape heads
    against JAX forward_views, fp32, 2e-5."""
    jcfg, params, model = _tiny()
    shapes = [(32, 48), (48, 80), (32, 48), (48, 32)]
    rng = np.random.default_rng(2)
    views = [{"img": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32),
              "true_shape": np.int32([[h, w]])} for h, w in shapes]
    ref = j_inf.forward_views(j_inf.Fast3R(jcfg, params), views)
    out = inference(views, model, verbose=False, image_ids=_jax_ids(4))
    _assert_preds(out["preds"], ref)


def test_profiling_gives_stage_times_and_same_preds():
    _, _, model = _tiny()
    rng = np.random.default_rng(3)
    for shapes in ([(32, 48)] * 3, [(32, 48), (48, 32), (32, 64)]):
        views = [{"img": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)}
                 for h, w in shapes]
        plain = inference(views, model, verbose=False)
        result, info = inference(views, model, verbose=False, profiling=True)
        assert set(info) == {"encode_images_time", "pos_emb_time",
                             "decoder_time", "head_forward_time",
                             "total_time"}
        assert info["pos_emb_time"] == 0.0 and info["total_time"] >= 0
        _assert_preds(result["preds"], plain["preds"],
                      dict(rtol=1e-6, atol=1e-6))


def test_inference_from_raw_matches_jax():
    """uint8 frames -> device preprocessing -> forward, against JAX's
    fused-ingest program.  The two resamplers agree except where a value
    sits on a rounding tie (a uint8 step, ~1e-5 of the values), which moves
    the tiny model's outputs by up to ~1e-4: 5e-4 here."""
    jcfg, params, model = _tiny()
    raw = np.stack([_photo(60, 90, s) for s in range(3)])
    ref = j_inf.inference_from_raw(list(raw), j_inf.Fast3R(jcfg, params),
                                   size=64, verbose=False)
    got = inference_from_raw(list(raw), model, size=64, verbose=False,
                             image_ids=_jax_ids(3))
    for a, b in zip(got["views"], ref["views"]):
        np.testing.assert_array_equal(a["true_shape"], b["true_shape"])
        assert np.abs(a["img"] - b["img"]).max() <= 2 / 127.5 + 1e-6
    _assert_preds(got["preds"], ref["preds"], dict(rtol=5e-4, atol=5e-4))


def _hf_cfg(decoder=None):
    """A small configuration the reference's *_args can describe: the
    DPT head at its published widths (the args carry no head widths)."""
    from fast3r_tpu.models.decoder import DecoderConfig
    from fast3r_tpu.models.dpt_head import DPTHeadConfig
    from fast3r_tpu.models.encoder import EncoderConfig

    return jf.Fast3RConfig(
        encoder=EncoderConfig(embed_dim=64, num_heads=2, depth=2),
        decoder=decoder or DecoderConfig(enc_embed_dim=64, embed_dim=64,
                                         num_heads=2, depth=4),
        head=DPTHeadConfig(dim_tokens=(64, 64, 64, 64)))


@pytest.fixture(scope="module")
def hf_export(tmp_path_factory):
    """A model exported by fast3r_tpu's convert_checkpoint_to_hf, seeded
    views, and JAX Fast3R.from_pretrained's predictions for them."""
    jcfg = _hf_cfg()
    out = tmp_path_factory.mktemp("hf")
    j_cu.convert_checkpoint_to_hf(
        j_inf.Fast3R(jcfg, _jax_params(jcfg, seed=7)), str(out))
    rng = np.random.default_rng(4)
    views = [{"img": rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)}
             for _ in range(3)]
    ref = j_inf.forward_views(j_inf.Fast3R.from_pretrained(str(out)), views)
    return out, views, ref


@pytest.mark.parametrize("form", ["safetensors", "bin"])
def test_from_pretrained_matches_jax(hf_export, tmp_path, form):
    """Fast3R.from_pretrained on the export, as model.safetensors (the
    port's own reader) and as pytorch_model.bin: the same preds as JAX
    Fast3R.from_pretrained, fp32, 2e-5."""
    path, views, ref = hf_export
    if form == "bin":
        src, path = path, tmp_path / "bin"
        path.mkdir()
        (path / "config.json").write_text((src / "config.json").read_text())
        sd = t_ckpt.read_safetensors(str(src / "model.safetensors"))
        torch.save({"state_dict": {f"net.{k}": v for k, v in sd.items()}},
                   path / "pytorch_model.bin")
    model = Fast3R.from_pretrained(str(path), device="cpu")
    _assert_preds(inference(views, model, verbose=False,
                            image_ids=_jax_ids(3))["preds"], ref)
    loaded = t_cu.load_model(str(path), device="cpu")
    assert loaded.cfg.encoder.patch_embed_cls == "PatchEmbedDust3R"


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(5)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float16),
              "empty": np.zeros((0, 2), np.float32)}
    save_file(arrays, str(tmp_path / "x.safetensors"))
    got = t_ckpt.read_safetensors(str(tmp_path / "x.safetensors"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    bf = torch.randn(4, 6, dtype=torch.bfloat16)
    save_torch({"bf": bf}, str(tmp_path / "y.safetensors"))
    assert torch.equal(t_ckpt.read_safetensors(
        str(tmp_path / "y.safetensors"))["bf"], bf)


def test_llama_reference_args_load(tmp_path):
    """A llama-decoder export (the reference's *_args with decoder_type
    llama): the port's loaded weights equal the JAX tree's."""
    from fast3r_tpu.models.llama_decoder import LlamaDecoderConfig as JL

    from fast3r_torch.utils.convert import params_from_jax

    jcfg = _hf_cfg(JL(enc_embed_dim=64, embed_dim=64, n_layers=4, n_heads=2))
    params = _jax_params(jcfg, seed=6)
    j_cu.convert_checkpoint_to_hf(j_inf.Fast3R(jcfg, params), str(tmp_path))
    model = Fast3R.from_pretrained(str(tmp_path), device="cpu")
    assert model.cfg.decoder_type == "llama"
    want = params_from_jax(jax.tree.map(np.asarray, params), model.cfg)
    got = model.params.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_load_model_run_dir_and_refusals(tmp_path):
    """A port Trainer's run directory loads with its weights; a fast3r_tpu
    orbax run directory and a hub id raise."""
    from fast3r_torch.train.step import OptimConfig
    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    _, _, model = _tiny()
    tr = Trainer(model.cfg, OptimConfig(),
                 trainer_cfg=TrainerConfig(run_dir=str(tmp_path / "run")),
                 params=model.to().params, device="cpu")
    tr.save_checkpoint("last")
    loaded = t_cu.load_model(str(tmp_path / "run"), device="cpu")
    for k, v in model.params.state_dict().items():
        assert torch.equal(loaded.params.state_dict()[k], v)
    orbax = tmp_path / "orbax"
    (orbax / "checkpoints").mkdir(parents=True)
    (orbax / "config.yaml").write_text("model: {}\n")
    with pytest.raises(ValueError, match="fast3r_tpu run directory"):
        t_cu.load_model(str(orbax), device="cpu")
    with pytest.raises(FileNotFoundError, match="not a local"):
        Fast3R.from_pretrained("jedyang97/Fast3R_ViT_Large_512", device="cpu")
