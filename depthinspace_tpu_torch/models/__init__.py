from .dispnet import DispNet, SigmoidAffineHead, init_dispnet_
from .fusenet import FuseNet, init_fusenet_, pointconv_select
from .convert import (dispnet_state_dict_from_flax,
                      flax_tree_from_dispnet_state_dict,
                      flax_tree_from_fusenet_state_dict,
                      fusenet_state_dict_from_flax)
