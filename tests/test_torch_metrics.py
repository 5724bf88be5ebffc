"""The port's evaluation metrics against the JAX package on the CPU: SSIM
and masked MSE on seeded numpy, LPIPS (alex and vgg) from one seeded
torch-named state_dict in every naming the loaders accept, the strictness
and net-mismatch errors, and the eval CLI on one PNG folder."""

import numpy as np
import pytest
import torch

from loco_edit_tpu.utils import metrics as jax_metrics
from loco_edit_tpu.utils.lpips_flax import LPIPSMetric as JaxLPIPSMetric
from loco_edit_tpu.utils.lpips_flax import convert_lpips_state_dict as jax_convert
from loco_edit_tpu_torch.utils import lpips as port_lpips
from loco_edit_tpu_torch.utils import metrics

torch.set_num_threads(2)

# LPIPS of both packages from one state_dict, relative to the larger value
# (f32 summation orders of two frameworks through 5 or 13 convolutions)
LPIPS_RTOL = 1e-5
_ALEX = ((0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3), (8, 384, 256, 3),
         (10, 256, 256, 3))
_VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def _features(net: str, seed: int) -> dict:
    """A seeded torchvision `features.I.{weight,bias}` backbone state_dict."""
    rng = np.random.default_rng(seed)
    if net == "alex":
        convs = [(fi, ci, co, k) for fi, ci, co, k in _ALEX]
    else:
        convs, fi, ci = [], 0, 3
        for bi, (co, n) in enumerate(_VGG_PLAN):
            fi += bi > 0          # the MaxPool slot
            for _ in range(n):
                convs.append((fi, ci, co, 3))
                fi, ci = fi + 2, co
    sd = {}
    for fi, ci, co, k in convs:
        std = (2.0 / (ci * k * k)) ** 0.5
        sd[f"features.{fi}.weight"] = torch.tensor(
            rng.normal(0, std, (co, ci, k, k)), dtype=torch.float32)
        sd[f"features.{fi}.bias"] = torch.tensor(rng.normal(0, 0.05, co), dtype=torch.float32)
    return sd


def _lins(net: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    chans = (64, 192, 384, 256, 256) if net == "alex" else (64, 128, 256, 512, 512)
    return {f"lin{k}.model.1.weight": torch.tensor(
        np.abs(rng.normal(0, 0.3, (1, c, 1, 1))), dtype=torch.float32)
        for k, c in enumerate(chans)}


def _named(net: str, naming: str, seed: int = 0) -> tuple[dict, dict | None]:
    """(state_dict, heads or None) of one seeded LPIPS in a naming:
    "lpips" (net.sliceK.I + linK and its lins.K alias), "torchmetrics"
    (one more net. prefix, the scaling buffers) or "pair" (the torchvision
    backbone and the heads' own file)."""
    feats, lins = _features(net, seed), _lins(net, seed + 1)
    if naming == "pair":
        return feats, lins
    sd = port_lpips.lpips_package_state_dict(
        port_lpips.convert_lpips_state_dict(feats, lins, net)[0], net)
    for k in range(5):
        sd[f"lins.{k}.model.1.weight"] = sd[f"lin{k}.model.1.weight"]
    if naming == "torchmetrics":
        sd = {f"net.{k}": v for k, v in sd.items()}
        sd["net.scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188])
        sd["net.scaling_layer.scale"] = torch.tensor([0.458, 0.448, 0.450])
    return sd, None


def _images(seed, size, b=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32),
            rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32))


def test_ssim_and_masked_mse_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(3, 24, 20, 1)) > 0.5
    for dr in (1.0, 255.0):
        got = metrics.ssim(a * dr, b * dr, data_range=dr, device="cpu").numpy()
        ref = np.asarray(jax_metrics.ssim(a * dr, b * dr, data_range=dr))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for m in (None, mask, ~mask):
        got = metrics.masked_mse(a, b, m, device="cpu").numpy()
        ref = np.asarray(jax_metrics.masked_mse(a, b, m))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got.shape == (3,)
    # tensors keep their device and give the same values
    t = metrics.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert t.device.type == "cpu" and t.shape == (3,)
    np.testing.assert_allclose(metrics.masked_mse(a, a, mask, device="cpu").numpy(), 0.0)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax_in_every_naming(net, tmp_path):
    """One seeded LPIPS written in the lpips, torchmetrics and pair namings:
    the port's metric from each file equals the JAX package's from the same
    file (to LPIPS_RTOL) at 64 px, and lpips_params_from_flax carries the
    JAX variables to the same state_dict."""
    a, b = _images(1, 64)
    got_all, ref = [], None
    for naming in ("lpips", "torchmetrics", "pair"):
        sd, lins = _named(net, naming)
        path = str(tmp_path / f"{naming}.pth")
        torch.save(sd, path)
        lin_path = None
        if lins is not None:
            lin_path = str(tmp_path / "lins.pth")
            torch.save(lins, lin_path)
        m = port_lpips.LPIPSMetric.from_torch_file(path, lin_path, device="cpu")
        assert m.net == net
        got = m(a, b, normalize=True).numpy()
        if ref is None:
            ref = JaxLPIPSMetric.from_torch_file(path, lin_path)(a, b, normalize=True)
        np.testing.assert_allclose(got, ref, rtol=LPIPS_RTOL, atol=0)
        got_all.append(got)
        # the metrics gate reads the same file, or the backbone:heads pair
        weights = path if lin_path is None else f"{path}:{lin_path}"
        gate = metrics.lpips(a, b, weights_path=weights, device="cpu").numpy()
        np.testing.assert_array_equal(gate, got)
    assert got_all[0].shape == (2,) and np.all(got_all[0] > 0)
    variables, jnet = jax_convert(*_named(net, "pair"))
    carried = port_lpips.lpips_params_from_flax(variables)
    mine, _ = port_lpips.convert_lpips_state_dict(*_named(net, "pair"))
    assert jnet == net and carried.keys() == mine.keys()
    for k in mine:
        assert torch.equal(carried[k], mine[k]), k


def test_lpips_strictness_mismatch_and_zero(tmp_path, monkeypatch):
    sd, _ = _named("alex", "lpips")
    with pytest.raises(ValueError, match="unconverted LPIPS keys"):
        port_lpips.convert_lpips_state_dict({**sd, "mystery.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="unconverted LPIPS keys"):
        jax_convert({**sd, "mystery.weight": torch.zeros(1)})
    feats, _ = _named("alex", "pair")
    with pytest.raises(ValueError, match="lin heads"):
        port_lpips.convert_lpips_state_dict(feats)
    path = str(tmp_path / "alex.pth")
    torch.save(sd, path)
    a, b = _images(2, 64, b=1)
    with pytest.raises(ValueError, match="'alex' backbone but net='vgg'"):
        metrics.lpips(a, b, net="vgg", weights_path=path, device="cpu")
    # LOCO_LPIPS_WEIGHTS is the gate's second source; a == b scores 0
    monkeypatch.setenv("LOCO_LPIPS_WEIGHTS", path)
    assert float(metrics.lpips(a, a, net="alex", device="cpu")[0]) == 0.0
    assert float(metrics.lpips(a, b, device="cpu")[0]) > 0
    monkeypatch.delenv("LOCO_LPIPS_WEIGHTS")
    try:
        import torchmetrics  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="LOCO_LPIPS_WEIGHTS"):
            metrics.lpips(a, b, device="cpu")


def test_eval_cli_matches_jax(tmp_path, capsys):
    """cli/eval.py of both packages over one folder of PNG pairs (and
    masks): the same printed line and value for ssim, mmse (masked and
    not) and lpips with local weights."""
    from PIL import Image

    from loco_edit_tpu.cli import eval as jax_eval
    from loco_edit_tpu_torch.cli import eval as port_eval

    rng = np.random.default_rng(5)
    preds, origs, masks = (tmp_path / "p", tmp_path / "o", tmp_path / "m")
    for d in (preds, origs, masks):
        d.mkdir()
    for i in range(2):
        o = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
        p = np.clip(o.astype(int) + rng.integers(-40, 40, o.shape), 0, 255).astype(np.uint8)
        Image.fromarray(o).save(origs / f"{i}.png")
        Image.fromarray(p).save(preds / f"{i}.png")
        np.save(masks / f"{i}.npy", rng.uniform(size=(48, 48)) > 0.5)
    weights = str(tmp_path / "alex.pth")
    torch.save(_named("alex", "lpips")[0], weights)
    base = ["--folder_preds", str(preds), "--folder_original", str(origs)]
    for extra in (["--eval_metric", "ssim"], ["--eval_metric", "mmse"],
                  ["--eval_metric", "mmse", "--mask_folder", str(masks)],
                  ["--eval_metric", "lpips", "--lpips_weights", weights]):
        got = port_eval.main(base + extra + ["--device", "cpu"])
        got_line = capsys.readouterr().out.strip().splitlines()[-1]
        ref = jax_eval.main(base + extra)
        ref_line = capsys.readouterr().out.strip().splitlines()[-1]
        assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), extra
        assert got_line.split(":")[0] == ref_line.split(":")[0]


def test_lpips_fallback_never_fetches(tmp_path, monkeypatch):
    """Without local LPIPS weights the torchmetrics fallback runs only when
    its torchvision backbone is already in the torch hub cache: otherwise it
    raises with guidance before torchmetrics (which would download the
    backbone) builds anything."""
    import sys
    import types

    built = []

    class Fetching:
        def __init__(self, *a, **k):
            built.append(k)
            raise AssertionError("torchmetrics would download the backbone")

    fake = types.ModuleType("torchmetrics.image.lpip")
    fake.LearnedPerceptualImagePatchSimilarity = Fetching
    for name in ("torchmetrics", "torchmetrics.image"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "torchmetrics.image.lpip", fake)
    monkeypatch.delenv("LOCO_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))
    a, b = _images(2, 64, b=1)
    for net in (None, "vgg"):
        with pytest.raises(FileNotFoundError, match="never downloads"):
            metrics.lpips(a, b, net=net, device="cpu")
    assert not built
    # with the backbone in the local cache the fallback goes on to build it
    ckpt = tmp_path / "hub" / "checkpoints" / "alexnet-owt-7be5be79.pth"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(b"")
    with pytest.raises(AssertionError, match="would download"):
        metrics.lpips(a, b, device="cpu")
    assert built == [{"net_type": "alex", "normalize": True}]
