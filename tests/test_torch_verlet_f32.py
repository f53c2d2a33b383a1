"""The general path in f32, the production type, against the JAX
package's: the LE mix on the melt32 start, 20 steps through ``run`` with
thermo rows every 10; integer fields (extruder tables, types, images,
counters, last events, flags, step) bit for bit, positions within 1e-3
(the fast engine's f32 tolerance), the extruder count of every row
equal."""

import numpy as np
import torch

from torch_parity import check_general_ints, general_pair


def test_trajectory_f32():
    (rs, rows), (ts, trows) = general_pair("le", "float32")
    check_general_ints(rs, ts)
    assert ts.x.dtype == torch.float32
    assert float(np.abs(rs.x - ts.x.numpy()).max()) < 1e-3
    assert [int(v) for v in rows.n_extruders] == \
        [r.n_extruders for r in trows]
    assert int(ts.n_moves) > 0
