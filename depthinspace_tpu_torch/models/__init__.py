from .dispnet import DispNet, SigmoidAffineHead, init_dispnet_
from .convert import (dispnet_state_dict_from_flax,
                      flax_tree_from_dispnet_state_dict)
