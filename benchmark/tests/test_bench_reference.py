"""The reference against the program's CPU path at a small size (this test
imports both; the reference itself imports nothing of the program)."""

import numpy as np
import pytest

from conftest import tiny_spec
from core.cell import Run, templates
from traffic import synthetic


def test_traffic_copy_equals_the_programs_generator():
    from mm2d3d_tpu_torch.data.synthetic import make_batch

    kw = dict(batch_size=2, height=30, width=40, n_points=256, num_classes=6,
              full_scale=4096)
    for variant in ("nuscenes", "kitti"):
        ours = synthetic.make_batch(np.random.RandomState(5), variant=variant, **kw)
        theirs = make_batch(np.random.RandomState(5), variant=variant, wire=True, **kw)
        for k, v in ours.items():
            np.testing.assert_array_equal(v, getattr(theirs, k).numpy(), err_msg=k)


def test_weight_names_are_the_programs(manifest_data):
    from mm2d3d_tpu_torch.run import build_task

    for cell in ("nusc_usa_sing.train", "vkitti_skitti.train"):
        spec = tiny_spec(manifest_data, cell)
        task = build_task(spec["config"], spec["config"]["num_classes"], device="cpu")
        t = templates(spec["config"])
        for br, net in (("2d", task.model2d), ("3d", task.model3d)):
            assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == t[br]


@pytest.mark.parametrize("cell", ["nusc_usa_sing.train", "vkitti_skitti.train"])
def test_train_steps_match_the_fp32_program(manifest_data, cell):
    spec = tiny_spec(manifest_data, cell)
    run = Run(spec, 21, "cpu")
    run.setup()
    run.window(0.01)
    run.release()
    n = run.compare()
    assert n["overflow"] == 0
    assert n["loss_gap"] < 1e-4
    assert n["grad_gap"] < 5e-3
    assert n["change_gap"] < 0.05  # Adam's round-off steps, see check.py


def test_eval_matches_the_fp32_program(manifest_data):
    spec = tiny_spec(manifest_data, "nusc_usa_sing.eval")
    run = Run(spec, 22, "cpu")
    run.setup()
    run.window(15.0)  # long enough for every sampled call, under load too
    run.release()
    n = run.compare()
    assert len(run.prog["logits"]) == 3
    assert n["cm_gap"] == 0 and n["overflow"] == 0
    assert max(n["logit_gap_2d"], n["logit_gap_3d"], n["loss_gap"]) < 1e-5
