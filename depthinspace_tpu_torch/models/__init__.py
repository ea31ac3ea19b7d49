from .dispnet import DispNet, SigmoidAffineHead, init_dispnet_
from .fusenet import FuseNet, init_fusenet_, pointconv_select
from .flownet import (FlowNet, correlation, epe, flow_all_pairs, flow_input,
                      init_flownet_, multiscale_epe_loss)
from .convert import (dispnet_state_dict_from_flax,
                      flax_tree_from_dispnet_state_dict,
                      flax_tree_from_flownet_state_dict,
                      flax_tree_from_fusenet_state_dict,
                      flownet_state_dict_from_flax,
                      fusenet_state_dict_from_flax,
                      head_state_dict_from_flax)
from .heads import (DispRowHead, MultiLinear, PosOutput, SigmoidAffine,
                    make_output_head, pos_to_depth)
