from .objective import (AugmentDraws, LossContext, augment_batch_device,
                        draw_augment, make_loss_context, mf_losses,
                        prepare_batch, preprocess_images, rigid_flow_device,
                        sf_losses)
from .state import TrainState
from .steps import (chunk_batch, make_mf_eval_step, make_mf_train_step,
                    make_sf_eval_step, make_sf_train_step)
