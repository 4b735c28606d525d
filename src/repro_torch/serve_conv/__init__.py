"""Lane-batched serving of HOBFLOPS CNN graphs (DESIGN.md §10-§11),
ported from the JAX package's ``repro.serve_conv``.

The bitslice carrier's pixel-row axis is the batch axis, so concurrent
requests pack into one wave that pays a single encode/decode and keeps
the paper's "very wide vectorized" datapath full.  Pieces:

* ``lanes``    — wave packer/unpacker with per-request slot bookkeeping
* ``engine``   — :class:`ConvServeEngine` = :class:`WaveScheduler`
                 (bounded queue, deadline-or-full admission, per-request
                 deadlines) + :class:`WaveExecutor` (retry/backoff,
                 bad-runner eviction, straggler observation), on the
                 graph's device; ``derive_max_batch`` from the memory a
                 wave costs
* ``policy``   — :class:`ServePolicy` knobs and the precision-degrading
                 :class:`OverloadController` hysteresis ladder
* ``errors``   — the typed ``ServeError`` taxonomy + request validation
* ``faults``   — chaos layer: injected build/wave failures,
                 stragglers, corrupted caches (tests + ``chip_smoke.py``)
* ``cache``    — wave-runner cache (evictable; a miss builds the graph's
                 kernels) + corruption-tolerant ``tune_conv_blocks``
                 disk persistence in the port's own file
* ``sharding`` — optional wave sharding over a list of torch devices
"""
from repro_torch.serve_conv.cache import (RunnerCache, bucket_for,
                                          bucket_sizes, load_tune_cache,
                                          save_tune_cache, tune_cache_path,
                                          tuned_conv_blocks)
from repro_torch.serve_conv.engine import (ConvRequest, ConvServeEngine,
                                           WaveExecutor, WaveScheduler,
                                           derive_max_batch)
from repro_torch.serve_conv.errors import (DeadlineExceededError,
                                           QueueFullError,
                                           RequestValidationError,
                                           ServeError, WaveExecutionError,
                                           WaveShardingError,
                                           validate_request_image)
from repro_torch.serve_conv.faults import (FaultInjector, FaultPlan,
                                           InjectedCompileError,
                                           InjectedFault, InjectedWaveError,
                                           chaos_seed, corrupt_runner_cache,
                                           corrupt_tune_cache)
from repro_torch.serve_conv.lanes import (WavePlan, WaveSlot, pack_wave,
                                          request_images, unpack_wave)
from repro_torch.serve_conv.policy import OverloadController, ServePolicy
from repro_torch.serve_conv.sharding import wave_mesh, wave_sharded_runner

__all__ = [
    "ConvRequest", "ConvServeEngine", "DeadlineExceededError",
    "FaultInjector", "FaultPlan", "InjectedCompileError", "InjectedFault",
    "InjectedWaveError", "OverloadController", "QueueFullError",
    "RequestValidationError", "RunnerCache", "ServeError", "ServePolicy",
    "WaveExecutionError", "WaveExecutor", "WavePlan", "WaveScheduler",
    "WaveShardingError", "WaveSlot", "bucket_for", "bucket_sizes",
    "chaos_seed", "corrupt_runner_cache", "corrupt_tune_cache",
    "derive_max_batch", "load_tune_cache", "pack_wave", "request_images",
    "save_tune_cache", "tune_cache_path", "tuned_conv_blocks",
    "unpack_wave", "validate_request_image", "wave_mesh",
    "wave_sharded_runner",
]
