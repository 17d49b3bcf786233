from repro_torch.core.kvcache.eviction import LRU, LRUK, S3FIFO, make_policy  # noqa: F401
from repro_torch.core.kvcache.pool import (DistributedKVPool, KVBlock,  # noqa: F401
                                           KVPoolError)
from repro_torch.core.kvcache.tiers import (CompressedPage, HostPagePool,  # noqa: F401
                                            INT8_WIRE_MAX_REL_ERR,
                                            compress_page, decompress_page,
                                            payload_nbytes)
