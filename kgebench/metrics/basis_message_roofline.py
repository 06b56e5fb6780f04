"""Kernels: ``basis_message_kernel``'s least time by the peaks for the
traced steps' calls, over its summed device time (%)."""
from kgebench.yardstick import work
from kgebench.yardstick.readers import roofline


def read(facts):
    calls = [(work.basis_message_bytes(e, nb, di, do),
              work.basis_message_ops(e, nb, di, do, on))
             for e, nb, di, do, on in facts.get("basis_message_calls", ())]
    return roofline(facts, ("basis_message_kernel",),
                    calls * facts.get("steps_traced", 0))
