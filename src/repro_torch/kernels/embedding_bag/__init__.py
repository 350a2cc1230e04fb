from repro_torch.kernels.embedding_bag.ops import (bag, embedding_bag,
                                                   embedding_bag_inorder,
                                                   embedding_bag_ref)

__all__ = ["bag", "embedding_bag", "embedding_bag_inorder",
           "embedding_bag_ref"]
