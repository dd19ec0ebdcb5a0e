"""The port's scaffold: configs against the reference registry, the weight
interchange, the device default of the entry points, the launcher, and
that the package never pulls in JAX or the reference package."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import config as jx_config
from repro.core import init_snn as jx_init_snn
from repro_torch import config
from repro_torch.core import SNN, init_snn
from repro_torch.interop import from_jax_params, to_numpy_params

SRC = Path(__file__).resolve().parents[1] / "src"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_registry_lists_the_reference_snns():
    assert list(config.list_snns()) == list(jx_config.list_snns())


@pytest.mark.parametrize("name", ["snn-mnist", "snn-seg"])
def test_config_fields_match_reference(name):
    got, want = config.get_snn(name), jx_config.get_snn(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]


def test_unknown_snn_raises():
    with pytest.raises(KeyError, match="snn-mnist"):
        config.get_snn("snn-imagenet")


@pytest.mark.parametrize("name", ["snn-mnist", "snn-seg"])
def test_weight_round_trip_is_bit_exact(name):
    """Every leaf of the reference's parameter tree, at its shapes, comes
    back unchanged (values drawn with numpy at the shapes jax.eval_shape
    gives the reference's init_snn)."""
    cfg = jx_config.get_snn(name)
    rng = np.random.default_rng(3)
    np_params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype),
        jax.eval_shape(lambda: jx_init_snn(jax.random.PRNGKey(3), cfg)))
    params = from_jax_params(np_params, device="cpu")
    assert all(p[k].dtype == torch.float32 and p[k].device.type == "cpu"
               for p in params["conv"] + params["dense"] for k in ("w", "b"))
    back = to_numpy_params(params)
    for kind in ("conv", "dense"):
        assert len(back[kind]) == len(np_params[kind])
        for a, b in zip(back[kind], np_params[kind]):
            for k in ("w", "b"):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])


def test_init_snn_shapes_follow_the_reference():
    cfg = config.get_snn("snn-mnist")
    params = init_snn(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = jax.eval_shape(lambda: jx_init_snn(jax.random.PRNGKey(0), cfg))
    for kind in ("conv", "dense"):
        for a, b in zip(params[kind], want[kind]):
            assert tuple(a["w"].shape) == b["w"].shape
            assert tuple(a["b"].shape) == b["b"].shape
    again = init_snn(torch.Generator().manual_seed(0), cfg, device="cpu")
    torch.testing.assert_close(params["conv"][1]["w"], again["conv"][1]["w"],
                               rtol=0, atol=0)


def test_entry_points_default_to_the_card():
    """Without ``device`` the entry points want CUDA: where there is none
    they raise instead of returning CPU tensors."""
    cfg = config.get_snn("snn-mnist")
    np_params = {"conv": [{"w": np.ones((3, 3, 1, 16), np.float32),
                           "b": np.zeros(16, np.float32)}], "dense": []}
    calls = [lambda: init_snn(torch.Generator(), cfg),
             lambda: from_jax_params(np_params),
             lambda: SNN(cfg, generator=torch.Generator())]
    for call in calls:
        if torch.cuda.is_available():
            leaf = call()
            leaf = leaf["conv"][0]["w"] if isinstance(leaf, dict) \
                else leaf.conv_w[0]
            assert leaf.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_package_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, dataclasses, torch\n"
        "import repro_torch, repro_torch.interop, repro_torch.launch.serve\n"
        "import repro_torch.launch.train, repro_torch.data.synthetic\n"
        "import repro_torch.kernels.spiking_conv_lif\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.lif\n"
        "import repro_torch.serving, repro_torch.obs, repro_torch.runtime\n"
        "import repro_torch.runtime.fault_tolerance\n"
        "import repro_torch.runtime.faults, repro_torch.runtime.straggler\n"
        "import repro_torch.perfmodel\n"
        "import repro_torch.api, repro_torch.api.session\n"
        "import repro_torch.api.specs, repro_torch.api._compat\n"
        "import repro_torch.dist, repro_torch.dist.mesh\n"
        "from repro_torch.config import get_snn\n"
        "from repro_torch.core import init_snn, snn_apply, build_schedule\n"
        "from repro_torch.core import snn_apply_chunked\n"
        "from repro_torch.core.snn_train import make_train_step\n"
        "from repro_torch.serving import EngineConfig, ServingEngine\n"
        "cfg = dataclasses.replace(get_snn('snn-mnist'), input_hw=(8, 8),\n"
        "                          conv_channels=(8, 8), timesteps=3)\n"
        "p = init_snn(torch.Generator().manual_seed(0), cfg, device='cpu')\n"
        "x = torch.rand((2, 8, 8, 1))\n"
        "for b in ('ref', 'batched', 'hopper'):\n"
        "    out = snn_apply(p, x, cfg, backend=b,\n"
        "                    schedule=build_schedule(p, cfg))\n"
        "    assert out.logits.shape == (2, 10)\n"
        "mom = {k: [{n: torch.zeros_like(t) for n, t in l.items()}\n"
        "           for l in v] for k, v in p.items()}\n"
        "make_train_step(cfg, backend='hopper')(p, mom, x,\n"
        "                                       torch.tensor([1, 2]))\n"
        "out = snn_apply_chunked(p, x, cfg, chunk_timesteps=2,\n"
        "                        backend='hopper')\n"
        "assert out.logits.shape == (2, 10)\n"
        "eng = ServingEngine(p, cfg, EngineConfig(\n"
        "    backend='hopper', chunk_timesteps=2, device='cpu'))\n"
        "for f in x.numpy():\n"
        "    eng.submit(f)\n"
        "assert eng.run()['served'] == 2\n"
        "from repro_torch.api import ServeSpec, Session, TrainSpec\n"
        "sess = Session(cfg, ServeSpec(backend='hopper',\n"
        "               schedule_mode='aprc+cbws'), device='cpu')\n"
        "assert sess.infer(x.numpy()).logits.shape == (2, 10)\n"
        "sess.train_step(x, torch.tensor([1, 2]))\n"
        "assert 0.0 <= sess.evaluate(x, torch.tensor([1, 2])) <= 1.0\n"
        "from repro_torch.dist import parse_mesh\n"
        "assert TrainSpec(mesh=parse_mesh('data=2')).mesh == (('data', 2),)\n"
        "import repro_torch.dist.runner, repro_torch.dist.placement\n"
        "import repro_torch.sharding, repro_torch.sharding.cbws_sharding\n"
        "ms = Session(cfg, TrainSpec(backend='hopper', mesh={'data': 2}),\n"
        "             device='cpu')\n"
        "assert ms.infer(x.numpy()).logits.shape == (2, 10)\n"
        "ms.train_step(x, torch.tensor([1, 2]))\n"
        "import importlib.util, logging, pathlib\n"
        "import repro_torch.obs.log, repro_torch.obs.export\n"
        "import repro_torch.models.transformer, repro_torch.models.lm\n"
        "import repro_torch.models.counting, repro_torch.analysis\n"
        "from repro_torch.config import get_arch, reduced\n"
        "lm_cfg = reduced(get_arch('gemma3-4b'))\n"
        "lm = repro_torch.models.transformer.init_params(\n"
        "    torch.Generator().manual_seed(0), lm_cfg, device='cpu')\n"
        "with torch.inference_mode():\n"
        "    out = repro_torch.models.lm.make_prefill_step(lm_cfg)(\n"
        "        lm, {'tokens': torch.zeros((1, 4), dtype=torch.int32)})\n"
        "assert out[0].shape == (1, 1, lm_cfg.vocab_size)\n"
        "import repro_torch.optim, repro_torch.optim.adam\n"
        "import repro_torch.optim.schedules, repro_torch.optim.compression\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.checkpointer\n"
        "import repro_torch.data.pipeline, repro_torch.tree\n"
        "from repro_torch.runtime.fault_tolerance import ResilientLoop\n"
        "st = repro_torch.models.lm.init_train_state(\n"
        "    torch.Generator().manual_seed(0), lm_cfg, device='cpu')\n"
        "_, met = repro_torch.models.lm.make_train_step(lm_cfg)(st, {\n"
        "    'tokens': torch.zeros((1, 4), dtype=torch.int32),\n"
        "    'labels': torch.ones((1, 4), dtype=torch.int32)})\n"
        "assert int(st.opt.step) == 1 and met['loss'].shape == ()\n"
        "assert not repro_torch.analysis.check_cuda_abi()\n"
        "for name in ('quickstart', 'snn_mnist_train', 'serve_batched',\n"
        "             'snn_accelerator_sim'):\n"
        f"    path = pathlib.Path({str(SRC.parent / 'examples')!r})\n"
        "    path = path / f'torch_{name}.py'\n"
        "    spec = importlib.util.spec_from_file_location(path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "root = logging.getLogger('repro_torch')\n"
        "assert root.level == logging.WARNING and not root.handlers\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_launcher_serves_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--snn", "snn-mnist", "--backend", "hopper", "--batch", "2",
         "--steps", "1"], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "served 2 frames" in r.stderr and "backend=hopper" in r.stderr
