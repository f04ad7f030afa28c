"""The harness with the timed path broken underneath: each fault the cells
can have turns `correct` false, while the sound run is correct.  The runs
skip the look for a card and run at a small size on the CPU, the program in
fp32 so that the sound run reads far below every limit."""

import dataclasses

import pytest
import torch

from conftest import tiny_spec
from core.main import execute


def _run(man, cell, seconds=0.3):
    result, _ = execute(tiny_spec(man, cell), 31, seconds, False, "cpu", 0.0)
    return result


def _half(batch):
    b = batch.batch_size // 2
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[:b] for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})


@pytest.mark.parametrize("cell", ["nusc_usa_sing.train", "nusc_usa_sing.eval"])
def test_sound_run_is_correct(manifest_data, cell):
    assert _run(manifest_data, cell)["correct"] is True


def test_step_that_leaves_the_state_unchanged(manifest_data, monkeypatch):
    from mm2d3d_tpu_torch.train.step import MM2D3DTask

    step = MM2D3DTask.train_step

    def frozen(self, *a, **k):
        saved = [p.detach().clone() for net in (self.model2d, self.model3d)
                 for p in net.parameters()]
        logs = step(self, *a, **k)
        with torch.no_grad():
            for p, s in zip([p for net in (self.model2d, self.model3d)
                             for p in net.parameters()], saved):
                p.copy_(s)
        return logs

    monkeypatch.setattr(MM2D3DTask, "train_step", frozen)
    result = _run(manifest_data, "nusc_usa_sing.train")
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] > 0.9


def test_half_the_batch_left_out(manifest_data, monkeypatch):
    from mm2d3d_tpu_torch.train.step import MM2D3DTask

    step = MM2D3DTask.train_step
    monkeypatch.setattr(MM2D3DTask, "train_step",
                        lambda self, src, trg, *a, **k: step(self, _half(src), _half(trg),
                                                             *a, **k))
    assert _run(manifest_data, "nusc_usa_sing.train")["correct"] is False


def test_eval_on_half_the_batch(manifest_data, monkeypatch):
    from mm2d3d_tpu_torch.train.step import MM2D3DTask

    ev = MM2D3DTask.eval_step
    monkeypatch.setattr(MM2D3DTask, "eval_step",
                        lambda self, batch, *a, **k: ev(self, _half(batch), *a, **k))
    assert _run(manifest_data, "nusc_usa_sing.eval")["correct"] is False


def test_an_answer_altered_where_it_is_produced(manifest_data, monkeypatch):
    """One call's 3D logits rolled by a class, in the network that makes them."""
    from mm2d3d_tpu_torch.models.sparse_unet import Net3DSeg

    fwd = Net3DSeg.forward
    calls = []

    def altered(self, *a, **k):
        preds, out, aux = fwd(self, *a, **k)
        calls.append(1)
        if len(calls) == 3:  # the first window call (two warm-up calls before it)
            preds = {**preds, "seg_logit": preds["seg_logit"].roll(1, -1)}
        return preds, out, aux

    monkeypatch.setattr(Net3DSeg, "forward", altered)
    assert _run(manifest_data, "nusc_usa_sing.eval")["correct"] is False
