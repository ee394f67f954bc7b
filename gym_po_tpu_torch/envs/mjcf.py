"""Programmatic MJCF model builder for the ant POMDP arenas: a copy of
:mod:`gym_po_tpu.envs.mjcf` (stdlib XML only), the port's MuJoCo oracle
tests compile it.

The reference ships hand-written XML assets
(``gym_po/envs/assets/ant_tag_small.xml``, ``ant_heaven_hell.xml``);
here the models are *generated* with ``xml.etree`` from a compact leg/wall
specification — same physics (standard Gymnasium ant quadruped: sphere torso,
four 2-DoF legs, gear-15 torque actuators, RK4 at 2 ms... see the geometry
tables below), no asset files to ship or keep in sync.

Physical constants match the reference assets so behavior is comparable:

* ant: torso sphere r=0.25 at z=0.75, legs with hip (z-axis, ±30°) and ankle
  hinges (ranges ±(30,70)°), capsule radius 0.08, density 5, gear 15,
  actuator order hip_4, ankle_4, hip_1, ankle_1, hip_2, ankle_2, hip_3,
  ankle_3 (the reference's actuator order, which fixes the action layout);
* tag arena: square cage, walls at ±5.25 (reference ant_tag_small.xml:72-85);
  mocap bodies target / visible_area / tag_area in that order (the env moves
  ``mocap_pos[0]`` = target and ``mocap_pos[1:3]`` with the ant);
* heaven-hell arena: T-maze with corridor walls (ant_heaven_hell.xml:75-101),
  recolorable ``left_area`` / ``right_area`` sites at (∓6.25, 6.0) and a
  priest marker at (0, 6.0).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

__all__ = ["ant_tag_xml", "ant_heaven_hell_xml"]

# (hip_name, ankle_name, dx, dy, ankle_axis, ankle_range)
_LEGS = [
    ("front_left_leg", 1, 1.0, 1.0, "-1 1 0", "30 70"),
    ("front_right_leg", 2, -1.0, 1.0, "1 1 0", "-70 -30"),
    ("back_left_leg", 3, -1.0, -1.0, "-1 1 0", "-70 -30"),
    ("back_right_leg", 4, 1.0, -1.0, "1 1 0", "30 70"),
]
# reference actuator order (ant_tag_small.xml:114-123)
_ACTUATOR_ORDER = [4, 1, 2, 3]


def _root(model_name: str) -> ET.Element:
    root = ET.Element("mujoco", model=model_name)
    ET.SubElement(
        root, "compiler", angle="degree", coordinate="local", inertiafromgeom="true"
    )
    ET.SubElement(root, "option", integrator="RK4", timestep="0.02")
    default = ET.SubElement(root, "default")
    ET.SubElement(default, "joint", armature="1", damping="1", limited="true")
    ET.SubElement(
        default,
        "geom",
        conaffinity="0",
        condim="3",
        density="5.0",
        friction="1 0.5 0.5",
        margin="0.01",
        rgba="0.8 0.6 0.4 1",
    )
    return root


def _world(root: ET.Element, start_xy=(0.0, 1.0)) -> ET.Element:
    world = ET.SubElement(root, "worldbody")
    ET.SubElement(
        world,
        "light",
        cutoff="100",
        diffuse="1 1 1",
        dir="0 0 -1.3",
        directional="true",
        pos="0 0 1.3",
        specular=".1 .1 .1",
    )
    ET.SubElement(
        world,
        "geom",
        conaffinity="1",
        condim="3",
        name="floor",
        pos="0 0 0",
        rgba="0.8 0.9 0.8 1",
        size="40 40 40",
        type="plane",
    )
    _ant(world, start_xy)
    return world


def _ant(world: ET.Element, start_xy) -> None:
    torso = ET.SubElement(
        world, "body", name="torso", pos=f"{start_xy[0]} {start_xy[1]} 0.75"
    )
    ET.SubElement(
        torso, "camera", name="track", mode="trackcom", pos="0 -3 0.3",
        xyaxes="1 0 0 0 0 1",
    )
    ET.SubElement(torso, "geom", name="torso_geom", size="0.25", type="sphere")
    ET.SubElement(
        torso,
        "joint",
        armature="0",
        damping="0",
        limited="false",
        margin="0.01",
        name="root",
        type="free",
    )
    for name, i, sx, sy, ankle_axis, ankle_range in _LEGS:
        a, b = 0.2 * sx, 0.2 * sy
        leg = ET.SubElement(torso, "body", name=name, pos="0 0 0")
        ET.SubElement(
            leg, "geom", fromto=f"0 0 0 {a} {b} 0", name=f"aux_{i}_geom",
            size="0.08", type="capsule",
        )
        aux = ET.SubElement(leg, "body", name=f"aux_{i}", pos=f"{a} {b} 0")
        ET.SubElement(
            aux, "joint", axis="0 0 1", name=f"hip_{i}", range="-30 30",
            type="hinge",
        )
        ET.SubElement(
            aux, "geom", fromto=f"0 0 0 {a} {b} 0", name=f"leg_{i}_geom",
            size="0.08", type="capsule",
        )
        shin = ET.SubElement(aux, "body", pos=f"{a} {b} 0")
        ET.SubElement(
            shin, "joint", axis=ankle_axis, name=f"ankle_{i}",
            range=ankle_range, type="hinge",
        )
        ET.SubElement(
            shin, "geom", fromto=f"0 0 0 {2*a} {2*b} 0",
            name=f"ankle_{i}_geom", size="0.08", type="capsule",
        )


def _actuators(root: ET.Element) -> None:
    act = ET.SubElement(root, "actuator")
    for i in _ACTUATOR_ORDER:
        for joint in (f"hip_{i}", f"ankle_{i}"):
            ET.SubElement(
                act, "motor", ctrllimited="true", ctrlrange="-1.0 1.0",
                joint=joint, gear="15",
            )


def _wall(world: ET.Element, name: str, pos, size) -> None:
    body = ET.SubElement(
        world, "body", name=name, pos=f"{pos[0]} {pos[1]} 1"
    )
    ET.SubElement(
        body,
        "geom",
        type="box",
        size=f"{size[0]} {size[1]} 1",
        contype="1",
        conaffinity="1",
        rgba="0.4 0.4 0.4 1",
    )


def _marker(world, name, pos, size, rgba, mocap=False, site_name=None):
    kw = {"name": name, "pos": f"{pos[0]} {pos[1]} 0.4"}
    if mocap:
        kw["mocap"] = "true"
    body = ET.SubElement(world, "body", **kw)
    skw = {"type": "sphere", "size": str(size), "rgba": rgba}
    if site_name:
        skw["name"] = site_name
    ET.SubElement(body, "site", **skw)


def ant_tag_xml(half_extent: float = 5.25) -> str:
    """Tag cage (reference ant_tag_small.xml): square walls, mocap
    target/visible_area/tag_area in mocap slots 0/1/2."""
    root = _root("ant_tag")
    world = _world(root, start_xy=(0.0, 1.0))
    e = half_extent
    _wall(world, "north_wall", (0, e), (e, 0.25))
    _wall(world, "south_wall", (0, -e), (e, 0.25))
    _wall(world, "east_wall", (e, 0), (0.25, e))
    _wall(world, "west_wall", (-e, 0), (0.25, e))
    _marker(world, "target", (-4.75, 4.75), 0.4, "0 1 0 1", mocap=True,
            site_name="target")
    _marker(world, "visible_area", (0.0, 6.0), 3.0, "0 0 1 0.3", mocap=True)
    _marker(world, "tag_area", (0.0, 0.0), 1.5, "1 0 0 0.3", mocap=True)
    _actuators(root)
    return ET.tostring(root, encoding="unicode")


def ant_heaven_hell_xml() -> str:
    """T-maze (reference ant_heaven_hell.xml): stem corridor to a cross-bar
    with heaven/hell ends and a priest in the middle."""
    root = _root("ant_heaven_hell")
    world = _world(root, start_xy=(0.0, 0.0))
    _wall(world, "north_wall", (0, 8.25), (8.25, 0.25))
    _wall(world, "west_wall", (-8.25, 6.25), (0.25, 2.0))
    _wall(world, "east_wall", (8.25, 6.25), (0.25, 2.0))
    _wall(world, "south_wall_left", (-5.5, 4.25), (3.0, 0.25))
    _wall(world, "south_wall_right", (5.5, 4.25), (3.0, 0.25))
    _wall(world, "east_wall_below", (2.25, 1.5), (0.25, 3.0))
    _wall(world, "west_wall_below", (-2.25, 1.5), (0.25, 3.0))
    _wall(world, "north_wall_below", (0, -1.75), (2.5, 0.25))
    _marker(world, "priest", (0.0, 6.0), 0.4, "1 1 1 1")
    _marker(world, "priest_area", (0.0, 6.0), 2.0, "0 0 1 0.5")
    _marker(world, "heaven_marker", (-6.25, 6.0), 0.4, "0 1 0 1", mocap=True)
    _marker(world, "left_area", (-6.25, 6.0), 2.0, "0 1 0 0.5",
            site_name="left_area")
    _marker(world, "hell_marker", (6.25, 6.0), 0.4, "0 1 0 1", mocap=True)
    _marker(world, "right_area", (6.25, 6.0), 2.0, "1 0 0 0.5",
            site_name="right_area")
    _actuators(root)
    return ET.tostring(root, encoding="unicode")
