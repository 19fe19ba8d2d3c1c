from dedloc_tpu_torch.collaborative.progress import (
    LocalProgress,
    CollaborationState,
    ProgressTracker,
)
from dedloc_tpu_torch.collaborative.optimizer import CollaborativeOptimizer
