"""What ``correct`` is shown to fail, at a tiny size on the CPU: the control
(the reference in TF32, put in the program's place) against each cell's
limits, and whole runs with the timed path broken underneath: a step that
leaves its state unchanged, half of each batch left out with the mean taken
over the rest, a view's pixels altered where they are produced, half of a
view's rays left out. The cells run on one card, so no exchange between
cards can be left out."""

import pytest
import torch

from portbench import control
from portbench.tests import tiny

TRAIN = [c for c in tiny.all_cells() if "train" in c]
RENDER = [c for c in tiny.all_cells() if "render" in c]


def over(reading: dict, lim: dict) -> bool:
    return any(v > lim[k] for k, v in reading.items())


@pytest.mark.parametrize("cell", tiny.all_cells())
def test_control_fails_and_the_program_passes(cell):
    rows = control.main(["--workload", cell, "--seeds", "7,4294967299", "--control-seeds", "2"],
                        device="cpu", overrides=(dict(tiny.CFG), dict(tiny.TRAFFIC)),
                        bench=tiny.bench())
    lim = tiny.limits(cell)
    # the static method's kernel branch runs in f32 whatever compute_dtype
    # says, so only the composite cells have a bf16 path of the program's
    has_bf16 = not cell.startswith("static")
    for row in rows:
        assert not over(row["program"], lim), row
        assert over(row["control_tf32"], lim), row
        assert over(row["program_bf16"], lim) or not has_bf16, row
        if "fault_half_batch" in row:
            assert over(row["fault_half_batch"], lim), row


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(cell, monkeypatch):
    from nerfca_tpu_torch.train import step

    monkeypatch.setattr(step, "adam_update", lambda *a, **k: None)
    assert tiny.run(cell)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_each_batch_left_out_is_not_correct(cell, monkeypatch):
    from nerfca_tpu_torch.train import step

    real = step.sample_ray_batch

    def half(*a, **k):
        batch = real(*a, **k)
        n = batch["origins"].shape[0] // 2
        return {key: torch.cat([v[:n], v[:n]]) for key, v in batch.items()}

    monkeypatch.setattr(step, "sample_ray_batch", half)
    assert tiny.run(cell)["correct"] is False


@pytest.mark.parametrize("fault", ["one_pixel", "half_the_rays"])
@pytest.mark.parametrize("cell", RENDER)
def test_a_view_altered_where_it_is_produced_is_not_correct(cell, fault, monkeypatch):
    from nerfca_tpu_torch.train import evaluation

    real = evaluation.render_test_view

    def broken(*a, **k):
        out = real(*a, **k)
        # a composite view has three images; a static view has one
        for key in [name for name in ("pix", "pix_static", "pix_temp") if name in out]:
            pix = out[key].clone()
            if fault == "one_pixel":
                pix[len(pix) // 3] -= 1e-4
            else:
                n = len(pix) // 2
                pix[n:2 * n] = pix[:n]
            out[key] = pix
        return out

    monkeypatch.setattr(evaluation, "render_test_view", broken)
    assert tiny.run(cell)["correct"] is False
