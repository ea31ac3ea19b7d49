from .mesh import (check_batch_divides, pad_batch, pad_indices,
                   replicate_state, shard_batch, shard_indices)
from .multihost import (all_gather_batch, all_gather_object, all_reduce_sum,
                        barrier, broadcast_, broadcast_object, default_group,
                        init_multihost, is_primary, process_batch_bounds,
                        rank, world_size)
