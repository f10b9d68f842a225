"""Background integrity subsystem (the port of seaweedfs_tpu/scrub): the
volume server's scrubber and the master's repair queue."""

from seaweedfs_tpu_torch.scrub.scrubber import Scrubber  # noqa: F401
from seaweedfs_tpu_torch.scrub.repair_queue import RepairQueue  # noqa: F401
