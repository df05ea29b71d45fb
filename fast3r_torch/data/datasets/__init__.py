"""Dataset implementations + DSL registry.

Counterpart of ``fast3r_tpu/data/datasets/__init__.py``, holding what the port
has: the synthetic ``DummyMultiview`` and the six training datasets.  The
names in ``NOT_PORTED`` (the eval sets, ASE and the pairwise legacy loaders)
raise the DSL's unknown-name error, naming ROADMAP.md's queue.
"""

from fast3r_torch.data.datasets.dummy_multiview import DummyMultiview  # noqa: F401
from fast3r_torch.data.datasets.multiview import (  # noqa: F401
    ARKitScenes_Multiview,
    BlendedMVS_Multiview,
    Co3d_Multiview,
    Habitat_Multiview,
    MegaDepth_Multiview,
    ScanNetpp_Multiview,
)

# registered by fast3r_tpu.data.datasets, not yet by the port
NOT_PORTED = frozenset({
    "DTU", "NRGBD", "Co3d", "BaseManyViewDataset", "Demo", "Scannet",
    "SevenScenes", "ArkitScene", "BlendMVS", "BlendMVSEval", "HabitatEval",
    "Scannetpp", "ASE_Multiview", "Co3dPairwise", "StaticThings3D", "Waymo",
    "WildRGBD",
})
