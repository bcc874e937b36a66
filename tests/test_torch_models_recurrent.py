"""The port's recurrent families against the JAX package's, on the CPU:
recurrentgemma-2b (RG-LRU blocks and local attention) and xlstm-1.3b
(mLSTM and sLSTM), f32, within 1e-4 relative
(``test_torch_models_dense.check_family``).

``reduced()`` keeps 2 layers, which for the hybrid are 2 RG-LRU blocks and
no local attention, and for the xLSTM 2 remainder mLSTM blocks and no
sLSTM.  So the hybrid also runs at 4 layers (one (r, r, a) super-block and
a remainder block) and the xLSTM at 9 (one 7:1 super-block and a
remainder block).  On the CPU the hybrid's scan takes the RG-LRU plain
version, which launches no kernel."""

import pytest

from repro_torch.kernels.rglru_scan.kernel import rglru_scan
from test_torch_models_dense import check_family


@pytest.mark.parametrize("name,layers", [("recurrentgemma-2b", 2),
                                         ("recurrentgemma-2b", 4),
                                         ("xlstm-1.3b", 2),
                                         ("xlstm-1.3b", 9)])
def test_recurrent_family_matches_jax(name, layers):
    before = rglru_scan.launches
    check_family(name, n_layers=layers)
    assert rglru_scan.launches == before
