"""Port parity of the task registry and evaluation (``repro_torch.tasks``,
the trainer on a registry task) against ``repro.tasks``.

Tolerances: the seven tasks' compiled arrays bit for bit; the scorers'
float32 outputs (verbalizer logits, choice scores, answer logits) on
parameters carried across from the reference within atol 1e-4 (float32
sums in another order through a small float32 model), and a prediction
compared only where its top-2 margin exceeds that; chunked scoring gives
the same predictions as unchunked and scores within 1e-5; the ``sst2``
trainer's losses within rtol 1e-3 of the reference's (the bound of the
port's other trajectory tests: g = (l+ - l-)/2eps multiplies loss
rounding by 500).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import tasks as jtasks
from repro.configs import opt as jopt
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro_torch import api as tapi
from repro_torch import tasks as ttasks
from repro_torch.configs import opt as topt
from repro_torch.models import lm as tlm
from repro_torch.tasks import metrics as tmetrics
from repro_torch.train import trainer as ttrainer

torch.set_num_threads(2)              # six xdist workers share the CPUs

ATOL = 1e-4
N = 24


def test_registry_names_and_specs_match():
    assert ttasks.names() == jtasks.names()
    for name in jtasks.names():
        j, t = jtasks.get(name), ttasks.get(name)
        for f in ("kind", "template", "verbalizers", "choices_field",
                  "answer_field", "metric", "answer_len", "description"):
            assert getattr(t, f) == getattr(j, f), (name, f)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(jtasks.TASKS))
def test_compiled_task_bit_identical(name, seed):
    want = jtasks.build(name, vocab=512, seq_len=40, seed=seed
                        ).make_dataset(32)
    got = ttasks.build(name, vocab=512, seq_len=40, seed=seed
                       ).make_dataset(32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_json_examples(tmp_path):
    rows = [{"text": f"w{i} great movie", "label": i % 2} for i in range(7)]
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(rows))
    for n in (4, 7, 11):
        assert (ttasks.json_examples(str(path))(5, n)
                == jtasks.generators.json_examples(str(path))(5, n))
    kw = dict(name="json_sst", kind="classification",
              template="review : {text} . sentiment :",
              verbalizers=("terrible", "great"))
    want = jtasks.compile_task(jtasks.TaskSpec(
        generator=jtasks.json_examples(str(path)), **kw), 512, 24)
    got = ttasks.compile_task(ttasks.TaskSpec(
        generator=ttasks.json_examples(str(path)), **kw), 512, 24)
    for k, v in want.make_dataset(9).items():
        assert np.array_equal(got.make_dataset(9)[k], v), k
    path.write_text("{}")
    with pytest.raises(ValueError, match="non-empty JSON list"):
        ttasks.json_examples(str(path))(0, 1)


@pytest.fixture(scope="module")
def model():
    jc = jopt.opt_tiny(layers=2, d_model=32, vocab=512)
    tc = topt.opt_tiny(layers=2, d_model=32, vocab=512)
    jp = jlm.init_params(jc, jax.random.PRNGKey(2))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    return jc, tc, jp, tlm.params_from_numpy(tc, flat, "cpu")


def _margin_ok(scores):
    """Rows whose top-2 margin exceeds the tolerance."""
    top = np.sort(scores, axis=-1)
    return (top[:, -1] - top[:, -2]) > 2 * ATOL


@pytest.mark.parametrize("name", ["sst2", "cb", "copa", "squad_copy"])
def test_scorers_match_reference(model, name):
    jc, tc, jp, tp = model
    jt = jtasks.build(name, vocab=512, seq_len=24, seed=1)
    tt = ttasks.build(name, vocab=512, seq_len=24, seed=1)
    data = jt.make_dataset(N)
    kind = jt.kind
    if kind == "classification":
        import jax.numpy as jnp
        want = np.asarray(jtasks.metrics._logits_runner(jlm, True)(
            jc, jp, jnp.asarray(data["tokens"])))[:, jt.verb_ids]
        got = tmetrics.verbalizer_logits(tc, tp, data["tokens"], tt.verb_ids,
                                         tlm).numpy()
    elif kind == "multiple_choice":
        args = (data["choice_inputs"], data["choice_labels"],
                data["choice_mask"])
        want = jtasks.metrics.choice_scores(jc, jp, *args, jlm)
        got = tmetrics.choice_scores(tc, tp, *args, tlm)
    else:
        want = np.asarray(jtasks.metrics._full_logits(jc, jp, data["tokens"],
                                                      jlm))
        got = tmetrics.logits(tc, tp, data["tokens"], tlm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ok = _margin_ok(want.reshape(-1, want.shape[-1]))
    assert ok.mean() > 0.5
    pw = np.argmax(want.reshape(-1, want.shape[-1]), -1)
    pg = np.argmax(got.reshape(-1, got.shape[-1]), -1)
    assert np.array_equal(pg[ok], pw[ok])
    jpred = np.asarray(jt.predict(jc, jp, data, jlm))
    tpred = np.asarray(tt.predict(tc, tp, data, tlm))
    if kind == "generation":         # EM hits of rows whose every answer
        rows = ok.reshape(N, -1).all(-1)          # position is decided
        assert np.array_equal(tpred[rows], jpred[rows])
    else:
        assert np.array_equal(tpred[ok], jpred[ok])
        if ok.all():
            assert (tt.evaluate(tc, tp, data, tlm)
                    == jt.evaluate(jc, jp, data, jlm))


@pytest.mark.parametrize("name", ["sst2", "copa", "squad_copy"])
def test_chunked_scoring_equals_unchunked(model, name):
    _, tc, _, tp = model
    t = ttasks.build(name, vocab=512, seq_len=24, seed=4)
    data = t.make_dataset(N)
    whole = t.predict(tc, tp, data, tlm, chunk=None)
    for chunk in (1, 5, 16):
        assert np.array_equal(t.predict(tc, tp, data, tlm, chunk=chunk),
                              whole)
    assert (t.evaluate(tc, tp, data, tlm, chunk=7)
            == t.evaluate(tc, tp, data, tlm, chunk=None))
    if name == "copa":
        args = (data["choice_inputs"], data["choice_labels"],
                data["choice_mask"])
        np.testing.assert_allclose(
            tmetrics.choice_scores(tc, tp, *args, tlm, chunk=5),
            tmetrics.choice_scores(tc, tp, *args, tlm, chunk=None),
            rtol=0, atol=1e-5)


def test_trainer_on_sst2_matches_reference():
    spec = japi.with_overrides(japi.preset("tiny-smoke"), {
        "task.name": "sst2", "run.steps": 3, "run.eval_every": 1})
    want = japi.run(spec)
    jp = jlm.init_params(japi.derive(spec).model_cfg,
                         jax.random.PRNGKey(spec.run.seed))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    tspec = tapi.from_json(japi.to_json(spec))
    params = tlm.params_from_numpy(tapi.derive(tspec).model_cfg, flat, "cpu")
    got = tapi.run(tspec, device="cpu", params=params)
    wh, gh = want["history"], got["history"]
    np.testing.assert_allclose(gh["loss"], wh["loss"], rtol=1e-3)
    np.testing.assert_allclose(gh["val_loss"], wh["val_loss"], rtol=1e-3)
    assert gh["metric_name"] == wh["metric_name"] == "accuracy"
    assert got["summary"]["task"] == want["summary"]["task"] == "sst2"
    assert got["summary"]["metric"] == want["summary"]["metric"]
    np.testing.assert_allclose(gh["val_acc"], wh["val_acc"], atol=2 / 256)
    assert gh["best_step"] == 1 + int(np.argmax(gh["val_acc"]))
    assert sorted(gh["best_params"]) == sorted(flat)


@pytest.mark.parametrize("task_name,want_best", [("sst2", 2), (None, 3)])
def test_best_step_by_metric_or_by_loss(monkeypatch, task_name, want_best):
    """Registry tasks keep the highest metric (step 2 here), synthetic
    tasks the lowest validation loss (step 3), as in the reference."""
    scripted = iter([(2.0, 0.5), (3.0, 0.9), (1.0, 0.6)])
    monkeypatch.setattr(ttrainer.Trainer, "evaluate",
                        lambda self, p, v, max_examples=256: next(scripted))
    spec = tapi.with_overrides(tapi.preset("tiny-smoke"), {
        "task.name": task_name, "run.steps": 3, "run.eval_every": 1})
    hist = tapi.run(spec, device="cpu")["history"]
    assert hist["best_step"] == want_best
    assert ("metric_name" in hist) == (task_name is not None)


def test_evaluate_train_mode_scores_the_best_params():
    """``api.evaluate(mode="train")`` copies the best parameters into the
    live tensors before scoring them."""
    spec = tapi.with_overrides(tapi.preset("tiny-smoke"), {
        "task.name": "cb", "run.steps": 2, "run.eval_every": 1})
    rep = tapi.evaluate(spec, mode="train", device="cpu", n_examples=16)
    assert rep["task"] == "cb" and rep["metric"] == "macro_f1"
    assert rep["best_step"] in (1, 2)
    assert rep["trained"] == max(rep["val_metric_curve"])
    japi_rep = japi.evaluate(japi.with_overrides(
        japi.preset("tiny-smoke"), {"task.name": "cb", "run.steps": 2,
                                    "run.eval_every": 1}),
        mode="train", n_examples=16)
    assert sorted(k for k in rep if k != "spec") == sorted(
        k for k in japi_rep if k != "spec")


def test_sweep_runs_each_override():
    spec = tapi.with_overrides(tapi.preset("tiny-smoke"), {"run.steps": 1})
    out = tapi.sweep(spec, [{"optimizer.lr": 1e-4},
                            {"task.name": "boolq"}], device="cpu")
    assert [o["overrides"] for o in out] == [{"optimizer.lr": 1e-4},
                                             {"task.name": "boolq"}]
    assert out[1]["result"]["summary"]["task"] == "boolq"
    assert out[0]["result"]["spec"]["optimizer"]["lr"] == 1e-4
    first = tapi.run(tapi.with_overrides(spec, {"optimizer.lr": 1e-4}),
                     device="cpu")
    assert out[0]["result"]["history"]["loss"] == first["history"]["loss"]
