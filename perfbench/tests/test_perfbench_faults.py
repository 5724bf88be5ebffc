"""A run with the timed path broken underneath comes out not correct: for
each fault the served edit can have (one chip: no exchange between chips
to leave out)."""

import numpy as np
import pytest
import torch

import _tiny
from perfbench import harness


def _unchanged_step(monkeypatch):
    from loco_edit_tpu_torch.diffusion import sampling

    step = sampling.ddim_step

    def broken(xt, et, ab, ab_next, eta=0.0, noise=None):
        return xt, step(xt, et, ab, ab_next, eta=eta, noise=noise)[1]   # x_t unchanged

    monkeypatch.setattr(sampling, "ddim_step", broken)


def _half_batch(monkeypatch):
    from loco_edit_tpu_torch.pipelines import uncond

    gen = uncond.UncondEditPipeline.generate_chunked

    def broken(self, xt, start_idx=0, end_idx=None, boost=False):
        x = self._tensor(xt)
        h = x.shape[0] // 2
        out = gen(self, x[:h], start_idx, end_idx, boost)   # the other half left out:
        return torch.cat([out, torch.zeros_like(x[h:])])     # its rows never written

    monkeypatch.setattr(uncond.UncondEditPipeline, "generate_chunked", broken)


def _altered_frame(monkeypatch):
    from loco_edit_tpu_torch.pipelines import uncond

    split = uncond.split_pc_strips

    def broken(per_pc, batch_out):
        out = split(per_pc, batch_out)
        out[0] = out[0].copy()
        out[0][0] = 255 - out[0][0]                           # one frame altered
        return out

    monkeypatch.setattr(uncond, "split_pc_strips", broken)


def _altered_inner_frame(monkeypatch):
    from loco_edit_tpu_torch.pipelines import uncond

    split = uncond.split_pc_strips

    def broken(per_pc, batch_out):
        out = split(per_pc, batch_out)
        last = max(out)
        out[last] = out[last].copy()
        out[last][1] = 255 - out[last][1]                     # neither end nor centre
        return out

    monkeypatch.setattr(uncond, "split_pc_strips", broken)


def _reversed_walk(monkeypatch):
    from loco_edit_tpu_torch.pipelines import uncond

    split = uncond.split_pc_strips
    monkeypatch.setattr(uncond, "split_pc_strips",
                        lambda per_pc, out: {k: np.ascontiguousarray(np.asarray(v)[::-1])
                                             for k, v in split(per_pc, out).items()})


def _altered_direction(monkeypatch):
    from loco_edit_tpu_torch.pipelines import uncond

    project = uncond.null_space_project

    def broken(vT_modify, vT_null, rank_null=None):
        v = project(vT_modify, vT_null, rank_null)
        g = torch.Generator(device=v.device).manual_seed(0)
        return torch.nn.functional.normalize(
            v + 0.3 * torch.randn(v.shape, generator=g, device=v.device), dim=1)

    monkeypatch.setattr(uncond, "null_space_project", broken)


def _wrong_shape(monkeypatch):
    from loco_edit_tpu_torch.pipelines import uncond

    split = uncond.split_pc_strips
    monkeypatch.setattr(uncond, "split_pc_strips",
                        lambda per_pc, out: {k: np.asarray(v)[:-1]
                                             for k, v in split(per_pc, out).items()})


FAULTS = {"state_unchanged": _unchanged_step, "half_batch": _half_batch,
          "answer_altered": _altered_frame, "inner_frame_altered": _altered_inner_frame,
          "walk_reversed": _reversed_walk, "direction_altered": _altered_direction,
          "wrong_shape": _wrong_shape}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, tmp_path):
    torch.set_num_threads(2)
    FAULTS[fault](monkeypatch)
    out = harness.run_cell(_tiny.p2_cell("fp32"), 11, 0, False, "cpu",
                           workdir=str(tmp_path))
    assert out["correct"] is False, out["checks"]
