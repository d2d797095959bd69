"""The hand-written CUDA kernels' wrappers (`gossip`, `pad`, `extract`,
`runs`, `scatter`, `s2round`, `pairjoin`); each counts its launches in
`<wrapper>.launches`."""


def launch_counts() -> dict:
    """Every wrapper's launches so far, by kernel name (the names of
    chip_smoke.py's kernel line). Take the difference of two readings to
    count a call's launches without resetting anyone else's count."""
    from . import extract, gossip, pad, pairjoin, runs, s2round, scatter

    wrappers = {
        "gossip_compmin": gossip.compmin_gossip,
        "gossip_labeldist": gossip.label_gossip,
        "gossip_labelnd": gossip.label_flood,
        "gossip_value": gossip.value_flood,
        "gossip_subsum": gossip.subtree_sums,
        "pad_fields": pad.fast_pad_fields,
        "unpad_fields": pad.fast_unpad_fields,
        "boundary_extract": extract.boundary_extract,
        "closure_compmin": gossip.compmin_closure,
        "closure_labelnd": gossip.labelnd_closure,
        "closure_value": gossip.value_closure,
        "run_extract": runs.run_extract,
        "ordered_scatter_add": scatter.ordered_scatter_add,
        "s2_round": s2round.s2_round,
        "pair_join": pairjoin.pair_join,
    }
    return {name: fn.launches for name, fn in wrappers.items()}
