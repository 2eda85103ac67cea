"""Rapids, the expression language behind ``POST /3/Rapids``."""

from h2o_tpu_torch.rapids.interp import (Session, op_names,  # noqa: F401
                                         parse, rapids_exec)
