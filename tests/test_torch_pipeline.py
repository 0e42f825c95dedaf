"""The port's scheduler helpers, tracer and y4m concat against the JAX
package's (or their stated contract), on the CPU."""

import fractions
import json
import os

import numpy as np
import pytest
import torch

from reve_tpu.pipeline import scheduler as jscheduler
from reve_tpu_torch.io import concat, reader, writer
from reve_tpu_torch.pipeline import scheduler
from reve_tpu_torch.pipeline.planner import plan_segments
from reve_tpu_torch.pipeline.state import JobState, Workspace
from reve_tpu_torch.utils import trace

torch.set_num_threads(2)


def _y4m(path, frames=5, w=16, h=12):
    with writer.Y4MWriter(str(path), w, h, fractions.Fraction(24)) as wr:
        for i in range(frames):
            wr.write(reader.SyntheticReader.frame(i, h, w))
    return str(path)


def _state(inp, frames=5, w=16, h=12):
    return JobState(input_path=inp, output_path=inp + ".out.y4m", scale=2,
                    segment_size=2, frame_count=frames, fps_num=24,
                    fps_den=1, width=w, height=h,
                    pending=plan_segments(frames, 2))


@pytest.mark.parametrize("n", [0, 1, 7, 16, 17, 1000, 4321])
def test_sample_frame_indices_match_jax(n):
    assert scheduler.sample_frame_indices(n) == \
        jscheduler.sample_frame_indices(n)


def test_read_sampled_frames_seeks_the_right_frames(tmp_path):
    inp = _y4m(tmp_path / "in.y4m")
    got = scheduler.read_sampled_frames(_state(inp), "y4m", [1, 3])
    want = list(reader.Y4MReader(inp).read_range(0, 5))
    np.testing.assert_array_equal(got, np.stack([want[1], want[3]]))


def test_auto_dtype_resolves_bf16_first_wins(tmp_path):
    ws = Workspace(str(tmp_path / "ws"))
    ws.create()
    dtype, notes = scheduler.resolve_auto_dtype(ws)
    assert dtype == "bfloat16" and "not ported" in notes[0]
    dtype, notes = scheduler.resolve_auto_dtype(ws)
    assert dtype == "bfloat16" and "inherited" in notes[0]
    # a workspace the JAX package resolved to int8 is refused
    ws2 = Workspace(str(tmp_path / "ws2"))
    ws2.create()
    ws2.claim_resolution("int8", 55.0)
    with pytest.raises(NotImplementedError, match="int8"):
        scheduler.resolve_auto_dtype(ws2)


class _Engine:
    batch_size = 2


def test_queue_depth_hook_is_optional_but_not_swallowed(tmp_path):
    """Engines without recommended_queue_depth get the legacy depth; an
    AttributeError raised INSIDE a real implementation propagates."""
    inp = _y4m(tmp_path / "in.y4m")
    ws = Workspace(str(tmp_path / "ws"))
    ws.create()
    job = scheduler.PipelineJob(_state(inp), ws, _Engine())
    assert job.encode_q.maxsize == 3

    class Broken(_Engine):
        def recommended_queue_depth(self, h, w):
            return self.no_such_attribute

    with pytest.raises(AttributeError, match="no_such_attribute"):
        scheduler.PipelineJob(_state(inp), ws, Broken())


def test_y4m_concat_is_byte_exact_and_checks_headers(tmp_path):
    a = _y4m(tmp_path / "a.y4m", frames=2)
    b = _y4m(tmp_path / "b.y4m", frames=3)
    out = str(tmp_path / "out.y4m")
    report = concat.concatenate([a, b], a, out, fractions.Fraction(24))
    assert report == {"backend": "y4m", "audio_copied": False}
    with open(a, "rb") as fa, open(b, "rb") as fb, open(out, "rb") as fo:
        head = fa.readline()
        fb.readline()
        assert fo.read() == head + fa.read() + fb.read()
    assert reader.Y4MReader(out).frame_count() == 5
    c = _y4m(tmp_path / "c.y4m", frames=1, w=8, h=8)
    with pytest.raises(ValueError, match="header"):
        concat.y4m_concat([a, c], str(tmp_path / "bad.y4m"))


def test_tracer_and_torch_profile(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(path)
    with tr.span("submit", seg=1):
        pass
    tr.close()
    rec = json.loads(open(path).read())
    assert rec["ev"] == "submit" and rec["seg"] == 1 and "dur" in rec
    prof_dir = str(tmp_path / "prof")
    with trace.device_profile(prof_dir):
        torch.ones(8).sum()
    assert os.path.getsize(os.path.join(prof_dir, "trace.json")) > 0
    with trace.device_profile(None):
        pass
