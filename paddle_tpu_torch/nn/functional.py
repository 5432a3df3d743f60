"""paddle.nn.functional of the port (counterpart of
paddle_tpu/nn/functional.py): the activations, ops/nn_functional.py,
``pad``, ``gather_tree`` and ``diag``."""
from ..ops.activation import *  # noqa: F401,F403
from ..ops.nn_functional import *  # noqa: F401,F403
from ..ops.manipulation import pad  # noqa: F401
from .layers.decode import gather_tree  # noqa: F401
from ..ops.creation import diag  # noqa: F401
