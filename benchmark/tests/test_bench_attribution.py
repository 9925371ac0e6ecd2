"""The pass attribution of replays: learned from an eager frame's markers,
applied by position, refused where the sequences differ."""

import pytest

from benchmark import trace as tr


def acts(names, t0=0.0):
    return [tr.Activity(n, t0 + 10 * i, t0 + 10 * i + 5) for i, n in enumerate(names)]


EAGER = acts(["Memcpy HtoD (Pageable -> Device)", "spin_kernel", "cull_a", "spin_kernel", "gb_a",
              "gb_b", "spin_kernel", "post_a", "spin_kernel", "stats_a",
              "Memcpy DtoH (Device -> Pinned)"])


def test_split_passes():
    p = tr.split_passes(EAGER, ["Cull", "GBuffer", "Post"])
    assert {k: [a.name for a in v] for k, v in p.items()} == {
        "Cull": ["cull_a"], "GBuffer": ["gb_a", "gb_b"], "Post": ["post_a"],
        "stats": ["stats_a"]}


def test_split_refuses_missing_markers():
    with pytest.raises(tr.AttributionError):
        tr.split_passes(EAGER[2:], ["Cull", "GBuffer", "Post"])


def replay():
    return ["cull_a", "gb_a", "gb_b", "post_a", "stats_a"]


def test_match_by_position_around_copies():
    p = tr.split_passes(EAGER, ["Cull", "GBuffer", "Post"])
    trace = acts(["Memcpy HtoD", "copy_k"] + replay() + ["clone", "Memcpy HtoD"] + replay()
                 + ["clone"])
    frames = tr.match_replays(trace, p, 2)
    assert [a.name for a in frames[1]["GBuffer"]] == ["gb_a", "gb_b"]
    assert frames[1]["GBuffer"][0].start == trace[10].start


@pytest.mark.parametrize("bad", [
    ["cull_a", "gb_a", "post_a", "stats_a"],                 # an activity missing
    ["cull_a", "gb_a", "gb_x", "post_a", "stats_a"],         # another kernel
    ["cull_a", "gb_b", "gb_a", "post_a", "stats_a"],         # another order
])
def test_match_refuses_a_differing_replay(bad):
    p = tr.split_passes(EAGER, ["Cull", "GBuffer", "Post"])
    with pytest.raises(tr.AttributionError):
        tr.match_replays(acts(replay() + bad), p, 2)


def test_copies_match_by_kind():
    """A graph's copy nodes carry other names than a stream's copies."""
    eager = acts(["spin_kernel", "k1", "Memcpy DtoD (Device -> Device)", "spin_kernel", "k2",
                  "spin_kernel"])
    p = tr.split_passes(eager, ["A", "B"])
    frames = tr.match_replays(acts(["k1", "memcpy_post", "k2"]), p, 1)
    assert [a.name for a in frames[0]["A"]] == ["k1", "memcpy_post"]


def test_busy_is_the_union():
    assert tr.busy_us([tr.Activity("a", 0, 10), tr.Activity("b", 5, 15),
                       tr.Activity("c", 20, 25)]) == 20
