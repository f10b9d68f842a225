"""QoS traffic classes (the port of seaweedfs_tpu/qos's classes only; the
admission limiter and governor are not ported)."""

from seaweedfs_tpu_torch.qos.classes import (BACKGROUND, CLASS_HEADER,
                                             CLASSES, INTERACTIVE, WRITE,
                                             class_scope, current_class)

__all__ = ["BACKGROUND", "CLASS_HEADER", "CLASSES", "INTERACTIVE", "WRITE",
           "class_scope", "current_class"]
