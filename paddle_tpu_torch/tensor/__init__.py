"""``paddle.tensor`` (port of ``paddle_tpu/tensor/__init__.py``): the op
functions under the module paths v1 code imports from
(``paddle.tensor.math``, ``creation``, ``manipulation``, ``linalg``,
``search``, ``logic``, ``random``, ``attribute``, ``stat``)."""
import types as _types

from ..ops import creation, linalg, manipulation, math, misc  # noqa: F401
from ..ops.creation import *  # noqa: F401,F403
from ..ops.math import *  # noqa: F401,F403
from ..ops.manipulation import *  # noqa: F401,F403
from ..ops.linalg import *  # noqa: F401,F403

random = creation
attribute = math
stat = math
logic = math
# search spans both modules in the reference: sort/searchsorted with
# manipulation, argmax/argmin with math
search = _types.SimpleNamespace(
    **{n: getattr(manipulation, n) for n in manipulation.__all__},
    **{n: getattr(math, n) for n in ("argmax", "argmin")},
)
