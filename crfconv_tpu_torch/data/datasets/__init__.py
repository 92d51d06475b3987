from crfconv_tpu_torch.data.datasets.shapenet import ShapeNetNormalDataset  # noqa: F401
from crfconv_tpu_torch.data.datasets.s3dis import (  # noqa: F401
    S3DISRoom,
    S3DISRoomDataset,
    S3DISBlockDataset,
)
from crfconv_tpu_torch.data.datasets.semantic3d import (  # noqa: F401
    Semantic3D,
    Semantic3DBlockDataset,
    Semantic3DWholeDataset,
)
from crfconv_tpu_torch.data.datasets.scannet import ScanNetDataset  # noqa: F401
from crfconv_tpu_torch.data.datasets.npm3d import NPM3DDataset  # noqa: F401
from crfconv_tpu_torch.data.datasets.semantickitti import (  # noqa: F401
    SemanticKITTIDataset,
)
