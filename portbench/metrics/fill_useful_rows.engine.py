"""fill_useful_rows.engine: rows admitted over rows encoded: every fill
encodes all the engine's slots, whatever joins."""


def read(obs: dict):
    if obs.get("kind") != "open_loop":
        return None
    admitted = [n for _, _, n in obs["steps"] if n > 0]
    if not admitted:
        return None
    return 100.0 * sum(admitted) / (len(admitted) * obs["slots"])
