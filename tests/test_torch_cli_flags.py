"""The port's CLI surface against the JAX package's: the training flags
`--lr`, `--fix-flownet` and `--fix-depthnet`; `--pretrained-torch`, which
loads what the weight tables cover and reports the rest; and `validate`'s
progress lines and `test/*` image panes.

The validation schedule is compared with fakes in place of the networks on
both sides (the JAX package's production `validate` with a stand-in for its
chained eval program, the port's with a stand-in for `eval_metrics`), so
nothing compiles: the test holds the lines, the pane tags and steps and the
pane pixels to JAX's.
"""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from imageio.v2 import imread
from torch_parity import random_variables

from deep_sfm_revisited_tpu import cli as jcli
from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu.train import loop as jloop
from deep_sfm_revisited_tpu.train.trainer import ChainedEval
from deep_sfm_revisited_tpu.utils import torch_port
from deep_sfm_revisited_tpu.utils.logging import MetricLogger as JMetricLogger
from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet as TSFMNet
from deep_sfm_revisited_tpu_torch.train import evaluate
from deep_sfm_revisited_tpu_torch.utils import tb_events, weights
from deep_sfm_revisited_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)
OVER = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
        "pose.num_correspondences": 128}


@pytest.mark.parametrize("argv", [
    ["--cfg", "kitti", "--lr", "1e-4", "--fix-flownet"],
    ["--cfg", "kitti", "-b", "4", "--lr", "0.002", "--fix-depthnet", "--epochs", "3"],
    ["--fix-flownet", "--fix-depthnet", "--nlabel", "64"],
    ["--cfg", "kitti", "--fix-flownet", "--override", "train.fix_flownet=False", "train.lr=3e-5"],
])
def test_config_from_args_equals_jax(argv):
    """The same argv through both parsers gives the same config, field by field."""
    argv = ["--data", "root", *argv]
    want = dataclasses.asdict(jcli.config_from_args(jcli.build_parser().parse_args(argv)))
    got = dataclasses.asdict(cli.config_from_args(cli.build_parser().parse_args(argv)))
    assert got == want


@pytest.fixture(scope="module")
def sfm_variables():
    net = JSFMNet(JConfig.kitti().override(**OVER))
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    K = jnp.asarray([[[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]]], jnp.float32)
    return random_variables(lambda r, t, k: net.init(
        jax.random.PRNGKey(0), r, t, k, key=jax.random.PRNGKey(1)), x, x, K, seed=7)


MISSING = "depth_estimator.dres0.0.0.weight"


def _checkpoint(variables, kind):
    """A reference-named state dict: the whole model less one key plus one
    that no table knows, or the flow net alone without its prefix (a
    flow-only checkpoint, reference `main.py:222-235`)."""
    sd = weights.jax_params_to_torch(variables)
    if kind == "one extra, one missing":
        del sd[MISSING]
        sd["posenet.fc.weight"] = torch.ones(3)
        return sd
    pre = "flow_estimator."
    return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}


@pytest.mark.parametrize("kind", ["one extra, one missing", "flow only, no prefix"])
def test_pretrained_torch_loads_what_the_tables_cover(sfm_variables, tmp_path, capsys, kind):
    """`--pretrained-torch`: the keys missing and unused are those the JAX
    converter reports on the same file, the counts are printed, the covered
    tensors are loaded and the model keeps its own where the file has none."""
    sd = _checkpoint(sfm_variables, kind)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"epoch": 0, "state_dict": sd}, path)
    model = TSFMNet(TConfig.kitti().override(**OVER), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = cli.load_pretrained_torch(path, model, model.cfg)

    jsd = torch_port.load_torch_checkpoint(path)
    _, jreport = torch_port.convert_reference_checkpoint(jsd, sfm_variables)
    assert sorted(report["missing"]) == sorted(jreport["missing"])
    assert report["unused"] == jreport["unused"]
    assert sorted(report["consumed"]) == sorted(jreport["consumed"])
    assert (f"torch port: {len(jreport['missing'])} missing, {len(jreport['unused'])} unused"
            in capsys.readouterr().out)
    state = model.state_dict()
    prefix = "" if kind.startswith("one") else "flow_estimator."
    for key in report["consumed"]:
        assert torch.equal(state[prefix + key], sd[key]), key
    loaded = {prefix + k for k in report["consumed"]}
    for key in set(state) - loaded:
        assert torch.equal(state[key], before[key]), key
    if kind.startswith("one"):
        assert report["missing"] == [MISSING] and "posenet.fc.weight" in report["unused"]
    else:
        assert all(k.startswith("depth_estimator.") or k.startswith("feature_extraction")
                   or k.startswith(("dres", "classify", "convs", "dep_convs"))
                   for k in report["missing"])


def test_pretrained_torch_leaves_a_network_without_a_table(sfm_variables, tmp_path, capsys):
    """A flow estimator the port has no table for leaves the flow net
    untouched while PSNet loads; with neither table, the run exits."""
    sd = weights.jax_params_to_torch(sfm_variables)
    path = str(tmp_path / "ref.pth.tar")
    torch.save(sd, path)
    model = TSFMNet(TConfig.kitti().override(**OVER), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = model.cfg.override(**{"flow.estimator": "FLOWNET"})
    cli.load_pretrained_torch(path, model, cfg)
    assert "leaving flow_net untouched" in capsys.readouterr().out
    for key, value in model.state_dict().items():
        if key.startswith("flow_estimator."):
            assert torch.equal(value, before[key]), key
        elif not key.endswith("num_batches_tracked"):
            assert torch.equal(value, sd[key]), key
    with pytest.raises(SystemExit, match="either"):
        cli.load_pretrained_torch(path, model, cfg.override(**{"depth.estimator": "PANET"}))


# the validation schedule: 5 batches, a line every 2, panes every 2
N_BATCHES, HW = 5, (8, 12)
NAMES = ("abs_rel", "a1")


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for i in range(N_BATCHES):
        out.append({"ref": rng.uniform(-1, 1, (1, *HW, 3)).astype(np.float32),
                    "depth_gt": rng.uniform(1, 50, (1, *HW)).astype(np.float32),
                    "sample_valid": np.array([1.0 if i != 2 else 0.0], np.float32),
                    "idx": np.array([i], np.int32)})
    metrics = rng.uniform(0.05, 0.5, (N_BATCHES, len(NAMES)))
    flows = rng.normal(0, 3, (N_BATCHES, *HW, 2)).astype(np.float32)
    depths = rng.uniform(1, 80, (N_BATCHES, *HW)).astype(np.float32)
    return out, metrics, flows, depths


class _FakeChainedEval(ChainedEval):
    """The JAX chained eval program's interface over precomputed metrics and
    outputs (sums weighted by `sample_valid`, as the program keeps them)."""

    def __init__(self, metrics, flows, depths, image_freq):
        self.metrics, self.flows, self.depths = metrics, flows, depths
        self.image_freq = image_freq

    def metric_names(self, state, one):
        return list(NAMES)

    def init_acc(self, state, one):
        return np.zeros(len(NAMES)), 0.0

    def __call__(self, state, batches, key, sums, count):
        for idx, valid in zip(np.asarray(batches["idx"])[:, 0],
                              np.asarray(batches["sample_valid"])[:, 0]):
            sums = sums + self.metrics[idx] * valid
            count = count + valid
        return sums, count

    def viz_outputs(self, state, one, key):
        i = int(np.asarray(one["idx"])[0])
        return self.flows[i][None], self.depths[i][None]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    logger = logging.getLogger(name)
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.handlers = [_Lines()]
    return logger


def _panes(run_dir):
    """{(tag, step): pixels} from the PNG files, and [(tag, step)] from the
    event file."""
    pngs = {f: imread(os.path.join(run_dir, f)) for f in os.listdir(run_dir)
            if f.endswith(".png")}
    (events,) = [f for f in os.listdir(run_dir) if "tfevents" in f]
    tags = [(e["tag"], e["step"]) for e in tb_events.read_events(os.path.join(run_dir, events))
            if "tag" in e]
    return pngs, tags


def test_validate_logs_and_panes_equal_jax(tmp_path, monkeypatch):
    """`validate` with a logger and a metric logger: the `Test: [done/n]`
    lines, the final line, and the `test/*` panes (tags, steps, pixels) that
    the JAX package's production `validate` writes on the same batches."""
    batches, metrics, flows, depths = _batches()
    cfg = TConfig.kitti().override(**{"train.print_freq": 2, "train.image_freq": 2})

    jlog, jm = _logger("jax_validate"), JMetricLogger(str(tmp_path / "jax"), "test")
    jloop.validate(batches, None, _FakeChainedEval(metrics, flows, depths, 2),
                   jax.random.PRNGKey(0), jlog, None, 2, chain=1, metric_logger=jm)
    jm.close()

    def fake_eval_metrics(model, cfg_, batch, generator=None):
        i = int(batch["idx"][0])
        return ({k: torch.tensor(metrics[i][j]) for j, k in enumerate(NAMES)},
                {"flow": torch.from_numpy(flows[i][None]),
                 "depth": torch.from_numpy(depths[i][None])})

    monkeypatch.setattr(evaluate, "eval_metrics", fake_eval_metrics)
    tlog, tm = _logger("port_validate"), MetricLogger(str(tmp_path / "port"), "test")
    final = evaluate.validate(batches, torch.nn.Linear(1, 1), cfg, logger=tlog,
                              metric_logger=tm)
    tm.close()

    want_lines, got_lines = jlog.handlers[0].lines, tlog.handlers[0].lines
    assert got_lines == want_lines
    assert [x.split("]")[0] for x in got_lines[:-1]] == ["Test: [1/5", "Test: [3/5",
                                                          "Test: [5/5"]
    np.testing.assert_allclose(final["abs_rel"], np.average(metrics[:, 0], weights=[1, 1, 0, 1, 1]))
    want_png, want_tags = _panes(tmp_path / "jax" / "test")
    got_png, got_tags = _panes(tmp_path / "port" / "test")
    assert got_tags == want_tags
    assert {t for t, _ in got_tags} == {"test/input", "test/flow", "test/depth_pred",
                                        "test/depth_gt"}
    assert sorted({s for _, s in got_tags}) == [2, 4]
    assert set(got_png) == set(want_png)
    for name, img in want_png.items():
        np.testing.assert_array_equal(got_png[name], img, err_msg=name)
