"""A stand-in for `airmodes_torch.utils.graphs.CudaGraph` on the CPU, shared
by the port's graph tests (tests/test_torch_graphs.py,
tests/test_torch_dist_graphs.py) and the gloo workers of
tests/test_torch_multihost.py: with it installed, and `graphs._on_card`
answering yes, a graphed call on the CPU runs the mechanism (the key, the
input buffers, the clones, the counters) that a card runs."""

from __future__ import annotations

from airmodes_torch.utils import graphs


class FakeGraph:
    """Stand-in for `graphs.CudaGraph` on the CPU: capture runs the
    function (as the capture records it), replay runs it again and writes
    its outputs into the captured ones (as the graph rewrites its pool).
    A real replay runs no Python: while the stand-in's does, `replaying`
    is set (a test's counter stays put) and nested graphed calls run
    inline, as in a capture."""

    made = []
    replaying = False

    def __init__(self, dev):
        self.dev = dev
        self.run = None
        self.out = None
        self.replays = 0
        FakeGraph.made.append(self)

    def warm(self, run):
        run()

    def capture(self, run):
        self.run = run
        self.out = run()
        return self.out

    def replay(self):
        self.replays += 1
        FakeGraph.replaying = True
        try:
            with graphs._inline():
                out = self.run()
        finally:
            FakeGraph.replaying = False
        for dst, src in zip(_leaves(self.out), _leaves(out)):
            dst.copy_(src)


def _leaves(tree):
    out = []
    graphs._tree_map(out.append, tree)
    return out


def install_fake_graph(set_attr=setattr):
    """Put the stand-in in place (`set_attr`: pytest's
    `monkeypatch.setattr`, or `setattr` in a worker process)."""
    FakeGraph.made = []
    set_attr(graphs, "CudaGraph", FakeGraph)
    set_attr(graphs, "_on_card", lambda dev: True)
    return FakeGraph


def guard_transfers(sharded, set_attr=setattr):
    """Make `sharded._transfer` raise when it runs while a graph warms up,
    captures or replays: transfers between ranks belong to the steps'
    host fronts. Returns the list of plans that ran (outside graphs)."""
    real = sharded._transfer
    ran = []

    def guarded(mesh, plan):
        if getattr(graphs._local, "inline", 0):
            raise AssertionError("a transfer between ranks ran inside a "
                                 "graph's warm-up, capture or replay")
        if plan:
            ran.append(plan)
        return real(mesh, plan)

    set_attr(sharded, "_transfer", guarded)
    return ran
