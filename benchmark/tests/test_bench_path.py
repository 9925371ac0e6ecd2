"""The camera path is periodic and set by the seed."""

import json

from benchmark import cells

TRAFFIC = json.loads((cells.HERE / "traffic" / "stream.json").read_text())


def test_periodic():
    p = TRAFFIC["period"]
    for seed in (0, 7, 2**31 + 5, 3 * 10**9):
        for k in range(3 * p):
            assert cells.pose(TRAFFIC, seed, k) == cells.pose(TRAFFIC, seed, k + p)


def test_seeded():
    a = [cells.pose(TRAFFIC, 5, k)["yaw"] for k in range(10)]
    assert a == [cells.pose(TRAFFIC, 5, k)["yaw"] for k in range(10)]
    assert a != [cells.pose(TRAFFIC, 6, k)["yaw"] for k in range(10)]


def test_swing_stays_about_the_pose():
    yaws = [cells.pose(TRAFFIC, 0, k)["yaw"] for k in range(TRAFFIC["period"])]
    assert abs(max(yaws) - TRAFFIC["yaw"] - TRAFFIC["yaw_amplitude"]) < 1e-9
    assert abs(min(yaws) - TRAFFIC["yaw"] + TRAFFIC["yaw_amplitude"]) < 1e-9
