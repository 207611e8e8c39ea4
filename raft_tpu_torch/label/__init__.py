"""Label utilities of the port (counterpart of ``raft_tpu/label``)."""

from raft_tpu_torch.label.classlabels import (  # noqa: F401
    get_unique_labels,
    get_ovr_labels,
    make_monotonic,
)
from raft_tpu_torch.label.merge_labels import (  # noqa: F401
    MAX_LABEL, merge_labels)
