"""Build and probe rounds of the hash join per traced query, from the
program's ``ops.hash_join.ROUNDS`` counter; each round is a host sync."""


def begin(run):
    from cylon_tpu_torch.ops import hash_join

    return sum(hash_join.ROUNDS.values())


def read(run, token=None):
    from cylon_tpu_torch.ops import hash_join

    rounds = sum(hash_join.ROUNDS.values()) - token
    return rounds / run.trace.queries if rounds and run.trace.queries \
        else None
