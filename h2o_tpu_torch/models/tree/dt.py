"""DT — port of ``h2o_tpu/models/tree/dt.py`` (``DTModel``, ``DT``
:18-39): a single decision tree (reference hex/tree/dt/DT.java).

A DRF with one unsampled tree over every column: ``sample_rate`` 1,
``mtries`` the number of predictors, ``max_depth`` 10 and ``min_rows``
10 by default; leaf values are the class frequencies (or the mean
response).  At the default depth the tree grows on the dense heap and,
with the AUTO (UniformAdaptive) histograms, every level is one launch of
the adaptive kernel on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models.tree.drf import DRF, DRFModel


class DTModel(DRFModel):
    algo = "dt"


class DT(DRF):
    algo = "dt"
    model_cls = DTModel

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(ntrees=1, max_depth=10, min_rows=10.0, sample_rate=1.0,
                 mtries=-2)     # -2 = all columns (DRF.java)
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> DTModel:
        # one tree on every row, and every column at every split
        self.params.update(ntrees=1, sample_rate=1.0, mtries=len(x) or -1)
        return super()._fit(x, y, train, valid)
