from wgsassign_tpu_torch.io.beagle import BeagleData, read_beagle
from wgsassign_tpu_torch.io.ids import PopulationMap, read_ids

__all__ = ["BeagleData", "read_beagle", "PopulationMap", "read_ids"]
