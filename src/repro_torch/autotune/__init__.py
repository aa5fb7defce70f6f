"""The autotuner: the paper's §III-C/D tuning methodology, persistent and
falsifiable.

* :mod:`repro_torch.autotune.model`   — the analytic stage-2 and stage-3
  cost model and the per-device profile table (bytes moved, launch
  amortisation, Eq.-1 occupancy, the shared-memory cliff);
* :mod:`repro_torch.autotune.measure` — the timer (median of k calls after
  a warm-up; CUDA events on the card);
* :mod:`repro_torch.autotune.search`  — the model-pruned search (rank the
  whole ``(tw, fuse, batch)`` grid, time only the top-K and the static
  default, report predicted against measured) and the measured fused-tier
  and stage-3 crossovers;
* :mod:`repro_torch.autotune.cache`   — the JSON cache keyed by
  ``(device_kind, n, bw, dtype, compute_uv, backend)``, the reference's
  schema, ``$REPRO_TORCH_AUTOTUNE_CACHE``-overridable path.

``python -m repro_torch.autotune --shapes n=4096:bw=64`` tunes and
persists; ``tuning.PipelineConfig.resolve(autotune=True)`` reads the cache
(the analytic defaults on a miss).
"""

from repro_torch.autotune import cache, measure, model, search
from repro_torch.autotune.cache import (cache_path, lookup, lookup_crossover,
                                        lookup_stage3, store, store_crossover,
                                        store_stage3)
from repro_torch.autotune.measure import measure_seconds, time_stage2
from repro_torch.autotune.model import (PROFILES, DeviceProfile, device_kind,
                                        fused_cost, pipeline_cost,
                                        predicted_crossover,
                                        predicted_stage3_crossover,
                                        profile_for, stage3_cost, stage_cost,
                                        total_chase_cycles)
from repro_torch.autotune.search import (Candidate, FusedCrossoverResult,
                                         SearchResult, Stage3CrossoverResult,
                                         search_fused_crossover,
                                         search_stage3_crossover)
from repro_torch.autotune.search import search as run_search

__all__ = [
    "cache", "measure", "model", "search",
    "cache_path", "lookup", "store", "lookup_crossover", "store_crossover",
    "lookup_stage3", "store_stage3",
    "measure_seconds", "time_stage2",
    "DeviceProfile", "PROFILES", "device_kind", "pipeline_cost",
    "profile_for", "stage_cost", "total_chase_cycles",
    "fused_cost", "predicted_crossover", "stage3_cost",
    "predicted_stage3_crossover",
    "Candidate", "SearchResult", "run_search",
    "FusedCrossoverResult", "search_fused_crossover",
    "Stage3CrossoverResult", "search_stage3_crossover",
]
