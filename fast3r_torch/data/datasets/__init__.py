"""Dataset implementations + DSL registry.

Counterpart of ``fast3r_tpu/data/datasets/__init__.py``: the same names.
"""

from fast3r_torch.data.datasets.dummy_multiview import DummyMultiview  # noqa: F401
from fast3r_torch.data.datasets.eval_many_view import (  # noqa: F401
    DTU,
    NRGBD,
    Co3d,
    BaseManyViewDataset,
    Demo,
    Scannet,
    SevenScenes,
)
from fast3r_torch.data.datasets.multiview import (  # noqa: F401
    ARKitScenes_Multiview,
    BlendedMVS_Multiview,
    Co3d_Multiview,
    Habitat_Multiview,
    MegaDepth_Multiview,
    ScanNetpp_Multiview,
)
from fast3r_torch.data.datasets.eval_many_view_extra import (  # noqa: F401,E402
    ArkitScene,
    BlendMVS,
    HabitatEval,
    Scannetpp,
)

BlendMVSEval = BlendMVS  # backward-compat alias (same class in the DSL)
from fast3r_torch.data.datasets.ase_multiview import ASE_Multiview  # noqa: F401,E402
from fast3r_torch.data.datasets.pairwise_legacy import (  # noqa: F401,E402
    Co3dPairwise,
    StaticThings3D,
    Waymo,
    WildRGBD,
)
