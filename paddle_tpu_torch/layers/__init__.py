"""Layer DSL subset the transformer LM builds with (counterpart of
paddle_tpu/layers/)."""
from .. import ops as _ops  # noqa: F401  (registers op lowerings)
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403  (shadows ops.less_than etc.)
from .detection import *  # noqa: F401,F403
from .dist import *  # noqa: F401,F403
