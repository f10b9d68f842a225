"""Volume integrity scrubbing (the port of seaweedfs_tpu/scrub: the
scrubber; the master's repair queue comes with the master)."""

from seaweedfs_tpu_torch.scrub.scrubber import Scrubber  # noqa: F401
