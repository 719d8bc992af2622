"""The item loop of the ``torch.distributed`` rank scripts
(tests/_torch_dist_child.py, _torch_link_sharded_child.py,
_torch_link_pipeline_child.py).  Not a pytest module; imports no JAX.

A rank runs its items (field cases and checks) one after the other in one
process group.  An item that fails on one rank can leave the group unsound
for every later item: a rank that raised between two collectives, or whose
collective timed out, is one collective off from the others from then on.
So after each item the ranks agree on its outcome, through a file store of
their own (keyed values, which a collective that is off by one cannot
disturb).  When every rank passed, the next item runs; otherwise every rank
records the item's index as ``_stopped_after`` and stops, and the test
module starts the items after it in a fresh launch
(``test_torch_parallel._suite``): a failing item fails alone.
"""
import datetime
import json
import os
import time
import traceback

#: how long a rank waits for the others' outcome of an item: longer than
#: the ranks' collective time limit (60 s), so that a rank stuck in a
#: collective times out, fails the item and reports before this runs out
AGREE_S = 150


def run_items(todo, rank, world, out_dir, start=0):
    """Run ``todo[start:]`` (``(name, fn)`` pairs; ``fn()`` returns a dict
    of extras or raises) and write ``results_rank<rank>.json`` after each:
    ``{name: {"ok": bool, "msg": traceback or "", "seconds": wall time,
    ...}}``, and ``"_stopped_after": index`` when an item other than the
    last failed on some rank."""
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(out_dir, f"agree_from{start}"),
                           world)
    store.set_timeout(datetime.timedelta(seconds=AGREE_S))
    path = os.path.join(out_dir, f"results_rank{rank}.json")
    results = {}
    for i in range(start, len(todo)):
        name, fn = todo[i]
        t0 = time.perf_counter()
        try:
            results[name] = dict(ok=True, msg="", **fn())
        except Exception:
            results[name] = dict(ok=False, msg=traceback.format_exc())
        results[name]["seconds"] = time.perf_counter() - t0
        with open(path, "w") as f:
            json.dump(results, f)
        store.set(f"{i}/{rank}", "1" if results[name]["ok"] else "0")
        try:
            keys = [f"{i}/{r}" for r in range(world)]
            store.wait(keys)
            agreed = all(store.get(k) == b"1" for k in keys)
        except RuntimeError:      # a rank never reported: it hangs or died
            agreed = False
        if not agreed and i + 1 < len(todo):
            results["_stopped_after"] = i
            with open(path, "w") as f:
                json.dump(results, f)
            return
