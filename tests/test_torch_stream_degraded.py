"""The port's streaming engine under the degraded control plane.

The counterpart of ``tests/test_faults.py``'s ``TestStreamDegraded``: for
every cell of its ``_MATRIX`` (the wire, ack transport, crash and slow
faults, suspect masking, the pull policies), ``serve_stream`` on the dense
backend (``device="cpu"``) at chunks 64 and 400 gives every counter and
the final occupancy of the reference's ``serve_one`` on the same
``StreamSampler.full`` trace, so the carry threads the wire, the fault
mask and the token pool across chunk boundaries.  Every compared field is
an integer or an integer array: the tolerance is zero.
"""
import numpy as np
import pytest

import test_faults as _faults
from repro.serve import engine as jeng
from repro_torch.serve import engine as teng

BASE = dict(replicas=6, decode_slots=4, slots=400, load=0.9, queue_cap=256)
FIELDS = ("completed", "messages", "net_drops", "retrans", "dropped",
          "token_misses", "token_sum", "offered")


@pytest.mark.parametrize("knobs", _faults._MATRIX,
                         ids=[str(i) for i in range(len(_faults._MATRIX))])
def test_stream_matches_the_reference_fixed_horizon(knobs):
    jcell = jeng.ServeConfig(**BASE, **knobs)
    cell = teng.ServeConfig(**BASE, **knobs)
    wl = jeng.StreamSampler(3, jeng.StreamParams.for_cell(jcell)).full(jcell.slots)
    ref = jeng.serve_one(3, jcell, workload=wl)
    for chunk in (64, cell.slots):
        sampler = teng.StreamSampler(3, teng.StreamParams.for_cell(cell))
        res = teng.serve_stream(3, cell, chunk=chunk, sampler=sampler, device="cpu")
        for name in FIELDS:
            assert getattr(res, name) == getattr(ref, name), (name, chunk)
        np.testing.assert_array_equal(res.final_occupancy, ref.final_occupancy)
        assert res.count == ref.completed
