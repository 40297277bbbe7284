"""The MJCF replicas of the dm_control-suite domains, the port's own copy.

A copy of ``envpool_tpu/envs/mujoco/dmc/assets.py``: the strings and
templates of all 15 domains, unchanged, and ``DMC_XMLS``, the model
variants built from them. The host tier's domains (``domains.py``) load
them into ``mujoco``; on the device tier only the model writer reads them
(``device_model.write_models``), and the port runs from the ``.npz`` files
it extracted under ``models/dmc/``. The replicas keep the task-relevant
structure of the suite models (joint topology, actuation gearing, the named
geoms, sites and sensors the task logic reads, timesteps); purely visual
elements (materials, skybox, cameras) are omitted.
"""

PENDULUM_XML = """
<mujoco model="pendulum">
  <option timestep="0.02">
    <flag contact="disable"/>
  </option>
  <worldbody>
    <body name="pole" pos="0 0 0.6">
      <joint name="hinge" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom name="pole" type="capsule" fromto="0 0 0 0 0 0.5"
            size="0.045" mass="1"/>
    </body>
  </worldbody>
  <actuator>
    <motor name="torque" joint="hinge" gear="2" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""

_CARTPOLE_TMPL = """
<mujoco model="cart-pole">
  <option timestep="0.01"/>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 -0.05" size="4 4 0.2"
          contype="0" conaffinity="0"/>
    <geom name="rail1" type="capsule" pos="0 0.07 1" zaxis="1 0 0"
          size="0.02 2" contype="0" conaffinity="0"/>
    <geom name="rail2" type="capsule" pos="0 -0.07 1" zaxis="1 0 0"
          size="0.02 2" contype="0" conaffinity="0"/>
    <body name="cart" pos="0 0 1">
      <joint name="slider" type="slide" limited="true" axis="1 0 0"
             range="-1.8 1.8" solreflimit="0.08 1"/>
      <geom name="cart" type="box" size="0.2 0.15 0.1" mass="1"/>
      {poles}
    </body>
  </worldbody>
  <actuator>
    <motor name="slide" joint="slider" gear="10" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""

_POLE_TMPL = """
<body name="pole_{i}" pos="0 0 {z}">
  <joint name="hinge_{i}" type="hinge" axis="0 1 0"/>
  <geom name="pole_{i}" type="capsule" fromto="0 0 0 0 0 {length}"
        size="0.045" mass="{mass}"/>
{inner}
</body>
"""


def cartpole_xml(task_name: str) -> str:
  """Counterpart of GetCartpoleXML + XMLAddPoles (dmc/cartpole.h:39-48,
  dmc/utils.cc XMLAddPoles): chain n poles, each scaled 1/n."""
  n = {"two_poles": 2, "three_poles": 3}.get(task_name, 1)
  length = 1.0 / n
  mass = 0.1 / n
  inner = ""
  for i in range(n, 0, -1):
    inner = _POLE_TMPL.format(
      i=i, z=0 if i == 1 else length, length=length, mass=mass, inner=inner
    )
  return _CARTPOLE_TMPL.format(poles=inner)


POINT_MASS_XML = """
<mujoco model="point_mass">
  <option timestep="0.02"/>
  <worldbody>
    <geom name="ground" type="plane" pos="0 0 0" size="0.3 0.3 0.1"/>
    <geom name="target" pos="0 0 0.01" type="sphere" size="0.015"
          contype="0" conaffinity="0"/>
    <body name="pointmass" pos="0 0 0.01">
      <joint name="root_x" type="slide" axis="1 0 0" limited="true"
             range="-0.29 0.29"/>
      <joint name="root_y" type="slide" axis="0 1 0" limited="true"
             range="-0.29 0.29"/>
      <geom name="pointmass" type="sphere" size="0.01" mass="0.3"/>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t1">
      <joint joint="root_x" coef="1"/>
      <joint joint="root_y" coef="0"/>
    </fixed>
    <fixed name="t2">
      <joint joint="root_x" coef="0"/>
      <joint joint="root_y" coef="1"/>
    </fixed>
  </tendon>
  <actuator>
    <motor name="t1" tendon="t1" gear="0.1" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="t2" tendon="t2" gear="0.1" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""

REACHER_XML = """
<mujoco model="reacher">
  <option timestep="0.02">
    <flag contact="disable"/>
  </option>
  <worldbody>
    <geom name="ground" type="plane" pos="0 0 0" size="0.4 0.4 0.1"
          contype="0" conaffinity="0"/>
    <geom name="target" pos="0.1 0.1 0.01" type="sphere" size="0.05"
          contype="0" conaffinity="0"/>
    <body name="arm" pos="0 0 0.01">
      <joint name="shoulder" type="hinge" axis="0 0 1"/>
      <geom name="arm" type="capsule" fromto="0 0 0 0.12 0 0"
            size="0.01" mass="0.05"/>
      <body name="hand" pos="0.12 0 0">
        <joint name="wrist" type="hinge" axis="0 0 1" limited="true"
               range="-2.8 2.8"/>
        <geom name="hand" type="capsule" fromto="0 0 0 0.1 0 0"
              size="0.01" mass="0.05"/>
        <body name="finger_body" pos="0.12 0 0">
          <geom name="finger" type="sphere" size="0.01" mass="0.01"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="shoulder" joint="shoulder" gear="0.05" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="wrist" joint="wrist" gear="0.05" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""

# planar cheetah: same topology as the suite model (rootx/rootz/rooty +
# 6 limited leg joints), with the torso subtreelinvel sensor the task reads
CHEETAH_XML = """
<mujoco model="cheetah">
  <compiler angle="radian" coordinate="local"/>
  <option timestep="0.01"/>
  <default>
    <joint armature="0.1" damping="0.01" limited="true" stiffness="8"/>
    <geom conaffinity="0" condim="3" contype="1" friction="0.4 0.1 0.1"/>
  </default>
  <worldbody>
    <geom name="ground" type="plane" conaffinity="1" pos="0 0 0"
          size="60 5 0.2" friction="0.4 0.1 0.1"/>
    <body name="torso" pos="0 0 0.7">
      <joint name="rootx" type="slide" axis="1 0 0" limited="false"
             armature="0" damping="0" stiffness="0"/>
      <joint name="rootz" type="slide" axis="0 0 1" limited="false"
             armature="0" damping="0" stiffness="0"/>
      <joint name="rooty" type="hinge" axis="0 1 0" limited="false"
             armature="0" damping="0" stiffness="0"/>
      <geom name="torso" type="capsule" fromto="-0.5 0 0 0.5 0 0"
            size="0.046"/>
      <geom name="head" type="capsule" pos="0.6 0 0.1" axisangle="0 1 0 0.87"
            size="0.046 0.075"/>
      <body name="bthigh" pos="-0.5 0 0">
        <joint name="bthigh" type="hinge" axis="0 1 0" damping="6"
               range="-0.52 1.05" stiffness="240"/>
        <geom name="bthigh" type="capsule" pos="0.1 0 -0.13"
              axisangle="0 1 0 -3.8" size="0.046 0.145"/>
        <body name="bshin" pos="0.16 0 -0.25">
          <joint name="bshin" type="hinge" axis="0 1 0" damping="4.5"
                 range="-0.785 0.785" stiffness="180"/>
          <geom name="bshin" type="capsule" pos="-0.14 0 -0.07"
                axisangle="0 1 0 -2.03" size="0.046 0.15"/>
          <body name="bfoot" pos="-0.28 0 -0.14">
            <joint name="bfoot" type="hinge" axis="0 1 0" damping="3"
                   range="-0.4 0.785" stiffness="120"/>
            <geom name="bfoot" type="capsule" pos="0.03 0 -0.097"
                  axisangle="0 1 0 -0.27" size="0.046 0.094"/>
          </body>
        </body>
      </body>
      <body name="fthigh" pos="0.5 0 0">
        <joint name="fthigh" type="hinge" axis="0 1 0" damping="4.5"
               range="-1 0.7" stiffness="180"/>
        <geom name="fthigh" type="capsule" pos="-0.07 0 -0.12"
              axisangle="0 1 0 0.52" size="0.046 0.133"/>
        <body name="fshin" pos="-0.14 0 -0.24">
          <joint name="fshin" type="hinge" axis="0 1 0" damping="3"
                 range="-1.2 0.87" stiffness="120"/>
          <geom name="fshin" type="capsule" pos="0.065 0 -0.09"
                axisangle="0 1 0 -0.6" size="0.046 0.106"/>
          <body name="ffoot" pos="0.13 0 -0.18">
            <joint name="ffoot" type="hinge" axis="0 1 0" damping="1.5"
                   range="-0.5 0.5" stiffness="60"/>
            <geom name="ffoot" type="capsule" pos="0.045 0 -0.07"
                  axisangle="0 1 0 -0.6" size="0.046 0.07"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="bthigh" joint="bthigh" gear="120" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="bshin" joint="bshin" gear="90" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="bfoot" joint="bfoot" gear="60" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="fthigh" joint="fthigh" gear="120" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="fshin" joint="fshin" gear="60" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="ffoot" joint="ffoot" gear="30" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
  <sensor>
    <subtreelinvel name="torso_subtreelinvel" body="torso"/>
  </sensor>
</mujoco>
"""

ACROBOT_XML = """
<mujoco model="acrobot">
  <option timestep="0.01">
    <flag contact="disable"/>
  </option>
  <default>
    <joint damping="0.05"/>
  </default>
  <worldbody>
    <site name="target" pos="0 0 4" size="0.1"/>
    <body name="upper_arm" pos="0 0 2">
      <joint name="shoulder" type="hinge" axis="0 1 0"/>
      <geom name="upper_arm" type="capsule" fromto="0 0 0 0 0 1"
            size="0.049" mass="1"/>
      <body name="lower_arm" pos="0 0 1">
        <joint name="elbow" type="hinge" axis="0 1 0"/>
        <geom name="lower_arm" type="capsule" fromto="0 0 0 0 0 1"
              size="0.049" mass="1"/>
        <site name="tip" pos="0 0 1" size="0.01"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="elbow" joint="elbow" gear="2" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""

BALL_IN_CUP_XML = """
<mujoco model="ball_in_cup">
  <option timestep="0.002"/>
  <worldbody>
    <body name="cup" pos="0 0 0.6">
      <joint name="cup_x" type="slide" axis="1 0 0" limited="true"
             range="-0.4 0.4" damping="2"/>
      <joint name="cup_z" type="slide" axis="0 0 1" limited="true"
             range="-0.3 0.3" damping="2"/>
      <geom name="cup_left" type="capsule" fromto="-0.05 0 0 -0.05 0 0.1"
            size="0.008" mass="0.2"/>
      <geom name="cup_right" type="capsule" fromto="0.05 0 0 0.05 0 0.1"
            size="0.008" mass="0.2"/>
      <geom name="cup_bottom" type="capsule" fromto="-0.05 0 0 0.05 0 0"
            size="0.008" mass="0.2"/>
      <site name="cup_anchor" pos="0 0 0" size="0.005"/>
      <site name="target" pos="0 0 0.05" size="0.04 0.001 0.04"
            type="box"/>
    </body>
    <body name="ball" pos="0 0 0.2">
      <joint name="ball_x" type="slide" axis="1 0 0"/>
      <joint name="ball_z" type="slide" axis="0 0 1"/>
      <geom name="ball" type="sphere" size="0.025" mass="0.06"/>
      <site name="ball_site" pos="0 0 0" size="0.005"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="string" limited="true" range="0 0.3" width="0.002">
      <site site="cup_anchor"/>
      <site site="ball_site"/>
    </spatial>
  </tendon>
  <actuator>
    <motor name="cup_x" joint="cup_x" gear="1" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="cup_z" joint="cup_z" gear="1" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""

DMC_HOPPER_XML = """
<mujoco model="hopper">
  <option timestep="0.005"/>
  <default>
    <joint damping="0.1" armature="0.2" limited="true"/>
    <geom friction="0.7 0.1 0.1"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 0" size="40 1 0.1"/>
    <body name="torso" pos="0 0 1">
      <joint name="rootx" type="slide" axis="1 0 0" limited="false"
             damping="0" armature="0"/>
      <joint name="rootz" type="slide" axis="0 0 1" limited="false"
             damping="0" armature="0"/>
      <joint name="rooty" type="hinge" axis="0 1 0" limited="false"
             damping="0" armature="0"/>
      <geom name="torso" type="capsule" fromto="0 0 -0.05 0 0 0.2"
            size="0.0653"/>
      <body name="pelvis" pos="0 0 -0.05">
        <joint name="waist" type="hinge" axis="0 1 0" range="-0.5 0.5"/>
        <geom name="pelvis" type="capsule" fromto="0 0 0 0 0 -0.2"
              size="0.055"/>
        <body name="thigh" pos="0 0 -0.2">
          <joint name="hip" type="hinge" axis="0 1 0" range="-2.5 1.6"/>
          <geom name="thigh" type="capsule" fromto="0 0 0 0 0 -0.33"
                size="0.04"/>
          <body name="calf" pos="0 0 -0.33">
            <joint name="knee" type="hinge" axis="0 1 0" range="0.05 2.6"/>
            <geom name="calf" type="capsule" fromto="0 0 0 0 0 -0.32"
                  size="0.03"/>
            <body name="foot" pos="0 0 -0.32">
              <joint name="ankle" type="hinge" axis="0 1 0"
                     range="-1 1"/>
              <geom name="foot" type="capsule"
                    fromto="-0.08 0 -0.04 0.17 0 -0.04" size="0.03"/>
              <!-- touch zones: spheres covering the foot-capsule end
                   hemispheres so ground contacts register (dm_control's
                   touch sites enclose the contact points; radius must
                   exceed the 0.03 foot radius) -->
              <site name="toe_site" pos="0.17 0 -0.055" size="0.045"/>
              <site name="heel_site" pos="-0.08 0 -0.055" size="0.045"/>
            </body>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="waist" joint="waist" gear="30" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="hip" joint="hip" gear="40" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="knee" joint="knee" gear="30" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="ankle" joint="ankle" gear="10" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
  <sensor>
    <subtreelinvel name="torso_subtreelinvel" body="torso"/>
    <touch name="touch_toe" site="toe_site"/>
    <touch name="touch_heel" site="heel_site"/>
  </sensor>
</mujoco>
"""

DMC_WALKER_XML = """
<mujoco model="planar walker">
  <option timestep="0.0025"/>
  <default>
    <joint damping="0.1" armature="0.01" limited="true"/>
    <geom friction="0.7 0.1 0.1"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 0" size="40 1 0.1"/>
    <body name="torso" pos="0 0 1.3">
      <joint name="rootx" type="slide" axis="1 0 0" limited="false"
             damping="0" armature="0"/>
      <joint name="rootz" type="slide" axis="0 0 1" limited="false"
             damping="0" armature="0"/>
      <joint name="rooty" type="hinge" axis="0 1 0" limited="false"
             damping="0" armature="0"/>
      <geom name="torso" type="capsule" fromto="0 0 -0.3 0 0 0.3"
            size="0.07"/>
      <body name="right_thigh" pos="0 -0.05 -0.3">
        <joint name="right_hip" type="hinge" axis="0 1 0"
               range="-0.35 1.05"/>
        <geom name="right_thigh" type="capsule" fromto="0 0 0 0 0 -0.3"
              size="0.05"/>
        <body name="right_leg" pos="0 0 -0.3">
          <joint name="right_knee" type="hinge" axis="0 1 0"
                 range="-2.6 0"/>
          <geom name="right_leg" type="capsule" fromto="0 0 0 0 0 -0.25"
                size="0.04"/>
          <body name="right_foot" pos="0 0 -0.25">
            <joint name="right_ankle" type="hinge" axis="0 1 0"
                   range="-0.8 0.8"/>
            <geom name="right_foot" type="capsule"
                  fromto="-0.05 0 -0.05 0.15 0 -0.05" size="0.04"/>
          </body>
        </body>
      </body>
      <body name="left_thigh" pos="0 0.05 -0.3">
        <joint name="left_hip" type="hinge" axis="0 1 0"
               range="-0.35 1.05"/>
        <geom name="left_thigh" type="capsule" fromto="0 0 0 0 0 -0.3"
              size="0.05"/>
        <body name="left_leg" pos="0 0 -0.3">
          <joint name="left_knee" type="hinge" axis="0 1 0"
                 range="-2.6 0"/>
          <geom name="left_leg" type="capsule" fromto="0 0 0 0 0 -0.25"
                size="0.04"/>
          <body name="left_foot" pos="0 0 -0.25">
            <joint name="left_ankle" type="hinge" axis="0 1 0"
                   range="-0.8 0.8"/>
            <geom name="left_foot" type="capsule"
                  fromto="-0.05 0 -0.05 0.15 0 -0.05" size="0.04"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="right_hip" joint="right_hip" gear="100" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="right_knee" joint="right_knee" gear="50" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="right_ankle" joint="right_ankle" gear="20"
           ctrllimited="true" ctrlrange="-1 1"/>
    <motor name="left_hip" joint="left_hip" gear="100" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="left_knee" joint="left_knee" gear="50" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="left_ankle" joint="left_ankle" gear="20" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
  <sensor>
    <subtreelinvel name="torso_subtreelinvel" body="torso"/>
  </sensor>
</mujoco>
"""

FINGER_XML = """
<mujoco model="finger">
  <option timestep="0.01"/>
  <default>
    <joint damping="0.1"/>
    <geom friction="1 0.005 0.001"/>
  </default>
  <worldbody>
    <body name="proximal_body" pos="0 0 0.7">
      <joint name="proximal" type="hinge" axis="0 1 0" limited="true"
             range="-1.92 1.92" damping="2.5"/>
      <geom name="proximal_geom" type="capsule" fromto="0 0 0 0 0 -0.17"
            size="0.03"/>
      <body name="distal_body" pos="0 0 -0.17">
        <joint name="distal" type="hinge" axis="0 1 0" limited="true"
               range="-1.1 1.1" damping="2.5"/>
        <geom name="distal_geom" type="capsule" fromto="0 0 0 0 0 -0.16"
              size="0.028"/>
        <geom name="fingertip" type="capsule"
              fromto="0 0 -0.16 0 0 -0.19" size="0.03"/>
        <site name="touchtop_site" pos="0.01 0 -0.17" size="0.01"/>
        <site name="touchbottom_site" pos="-0.01 0 -0.21" size="0.01"/>
        <site name="tip" pos="0 0 -0.19" size="0.01"/>
      </body>
    </body>
    <body name="spinner" pos="0.2 0 0.4">
      <joint name="hinge" type="hinge" axis="0 1 0" damping="0.5"/>
      <geom name="cap1" type="capsule" fromto="0 0 -0.13 0 0 0.13"
            size="0.02" mass="0.1"/>
      <site name="spinner_site" pos="0 0 0" size="0.005"/>
      <site name="spintip" pos="0 0 0.13" size="0.01"/>
    </body>
    <site name="target" pos="0.2 0 0.55" size="0.07"/>
  </worldbody>
  <actuator>
    <motor name="proximal" joint="proximal" gear="3" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="distal" joint="distal" gear="1.5" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
  <sensor>
    <jointpos name="proximal" joint="proximal"/>
    <jointpos name="distal" joint="distal"/>
    <jointvel name="proximal_velocity" joint="proximal"/>
    <jointvel name="distal_velocity" joint="distal"/>
    <jointvel name="hinge_velocity" joint="hinge"/>
    <framepos name="tip" objtype="site" objname="tip"/>
    <framepos name="target" objtype="site" objname="target"/>
    <framepos name="spinner" objtype="site" objname="spinner_site"/>
    <touch name="touchtop" site="touchtop_site"/>
    <touch name="touchbottom" site="touchbottom_site"/>
  </sensor>
</mujoco>
"""


def swimmer_xml(task_name: str) -> str:
  """Counterpart of XMLMakeSwimmer (dmc/utils.cc:75-160): an n-link chain
  in a viscous fluid, per-link velocimeter+gyro, nose/target geoms."""
  n = {"swimmer6": 6, "swimmer15": 15}.get(task_name, 3)
  joint_range = 360.0 / n
  body = ""
  for i in range(n - 2, -1, -1):
    body = f"""
      <body name="segment_{i}" pos="0 .1 0">
        <joint name="joint_{i}" type="hinge" axis="0 0 1" limited="true"
               range="-{joint_range} {joint_range}"/>
        <geom name="visual_{i}" type="capsule" fromto="0 0 0 0 0.1 0"
              size="0.01"/>
        <site name="site_{i}" pos="0 0.05 0" size="0.005"/>
        {body}
      </body>"""
  actuators = "\n".join(
    f'    <motor name="motor_{i}" joint="joint_{i}" gear="5e-4"'
    f' ctrllimited="true" ctrlrange="-1 1"/>' for i in range(n - 1)
  )
  sensors = "\n".join(
    f'    <velocimeter name="velocimeter_{i}" site="site_{i}"/>\n'
    f'    <gyro name="gyro_{i}" site="site_{i}"/>'
    for i in range(n - 1)
  )
  return f"""
<mujoco model="swimmer">
  <compiler angle="degree"/>
  <option timestep="0.002" density="4000" viscosity="0.1">
    <flag contact="disable"/>
  </option>
  <worldbody>
    <light name="target_light" pos="0 0 1"/>
    <geom name="target" type="sphere" pos="1 1 0.01" size="0.04"
          contype="0" conaffinity="0"/>
    <body name="head" pos="0 0 0.01">
      <joint name="rootx" type="slide" axis="1 0 0"/>
      <joint name="rooty" type="slide" axis="0 1 0"/>
      <joint name="rootz" type="hinge" axis="0 0 1"/>
      <geom name="head_geom" type="capsule" fromto="0 0 0 0 0.05 0"
            size="0.012"/>
      <geom name="nose" type="sphere" pos="0 -0.02 0" size="0.008"/>
      <site name="head_site" pos="0 0 0" size="0.005"/>
      {body}
    </body>
  </worldbody>
  <actuator>
{actuators}
  </actuator>
  <sensor>
    <velocimeter name="velocimeter_head" site="head_site"/>
    <gyro name="gyro_head" site="head_site"/>
{sensors}
  </sensor>
</mujoco>"""

FISH_XML = """
<mujoco model="fish">
  <option timestep="0.004" density="5000" viscosity="0.1" gravity="0 0 0"/>
  <default>
    <joint damping="0.02" limited="true"/>
    <geom contype="0" conaffinity="0"/>
  </default>
  <worldbody>
    <geom name="target" type="sphere" pos="0 0 0.15" size="0.04"
          rgba="1 0 0 1"/>
    <body name="torso" pos="0 0 0.15">
      <joint name="root" type="free" limited="false" damping="0"/>
      <geom name="torso_geom" type="ellipsoid" size="0.01 0.04 0.02"
            mass="0.02"/>
      <geom name="mouth" type="sphere" pos="0 0.045 0" size="0.005"
            mass="0.001"/>
      <site name="torso_site" pos="0 0 0" size="0.002"/>
      <body name="tail" pos="0 -0.04 0">
        <joint name="tail1" type="hinge" axis="0 0 1" range="-0.8 0.8"/>
        <geom name="tail1_geom" type="ellipsoid" pos="0 -0.015 0"
              size="0.005 0.015 0.015" mass="0.004"/>
        <body name="tail_fin" pos="0 -0.03 0">
          <joint name="tail_twist" type="hinge" axis="0 1 0"
                 range="-0.8 0.8"/>
          <joint name="tail2" type="hinge" axis="0 0 1" range="-0.8 0.8"/>
          <geom name="tail2_geom" type="box" size="0.002 0.015 0.02"
                mass="0.002"/>
        </body>
      </body>
      <body name="fin_right" pos="-0.01 0 0">
        <joint name="finright_roll" type="hinge" axis="0 1 0"
               range="-1 1"/>
        <joint name="finright_pitch" type="hinge" axis="1 0 0"
               range="-1 1"/>
        <geom name="finright_geom" type="box" pos="-0.01 0 0"
              size="0.01 0.008 0.001" mass="0.001"/>
      </body>
      <body name="fin_left" pos="0.01 0 0">
        <joint name="finleft_roll" type="hinge" axis="0 1 0"
               range="-1 1"/>
        <joint name="finleft_pitch" type="hinge" axis="1 0 0"
               range="-1 1"/>
        <geom name="finleft_geom" type="box" pos="0.01 0 0"
              size="0.01 0.008 0.001" mass="0.001"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="tail1" joint="tail1" gear="5e-4" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="tail_twist" joint="tail_twist" gear="5e-4"
           ctrllimited="true" ctrlrange="-1 1"/>
    <motor name="tail2" joint="tail2" gear="5e-4" ctrllimited="true"
           ctrlrange="-1 1"/>
    <motor name="finright_roll" joint="finright_roll" gear="5e-4"
           ctrllimited="true" ctrlrange="-1 1"/>
    <motor name="finleft_roll" joint="finleft_roll" gear="5e-4"
           ctrllimited="true" ctrlrange="-1 1"/>
  </actuator>
  <sensor>
    <velocimeter name="torso_vel" site="torso_site"/>
    <gyro name="torso_gyro" site="torso_site"/>
  </sensor>
</mujoco>
"""

DMC_HUMANOID_XML = """
<mujoco model="humanoid">
  <option timestep="0.0025"/>
  <default>
    <joint damping="0.2" armature="0.02" limited="true"
           solimplimit="0 0.99 0.01"/>
    <geom condim="1" friction="0.7" solimp="0.9 0.99 0.003"
          solref="0.015 1"/>
    <motor ctrllimited="true" ctrlrange="-1 1"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 0" size="10 10 0.2"
          condim="3"/>
    <body name="torso" pos="0 0 1.5">
      <joint name="root" type="free" limited="false" damping="0"
             armature="0"/>
      <geom name="torso_geom" type="capsule" fromto="0 -0.07 0 0 0.07 0"
            size="0.07"/>
      <geom name="upper_waist" type="capsule"
            fromto="-0.01 -0.06 -0.12 -0.01 0.06 -0.12" size="0.06"/>
      <body name="head" pos="0 0 0.19">
        <geom name="head_geom" type="sphere" size="0.09"/>
      </body>
      <body name="lower_waist" pos="-0.01 0 -0.26">
        <joint name="abdomen_z" type="hinge" axis="0 0 1"
               range="-0.79 0.79" damping="5" stiffness="20"/>
        <joint name="abdomen_y" type="hinge" axis="0 1 0"
               range="-1.31 0.52" damping="5" stiffness="10"/>
        <geom name="lower_waist_geom" type="capsule"
              fromto="0 -0.06 0 0 0.06 0" size="0.06"/>
        <body name="pelvis" pos="0 0 -0.165">
          <joint name="abdomen_x" type="hinge" axis="1 0 0"
                 range="-0.61 0.61" damping="5" stiffness="10"/>
          <geom name="butt" type="capsule" fromto="-0.02 -0.07 0 -0.02 0.07 0"
                size="0.09"/>
          <body name="right_thigh" pos="0 -0.1 -0.04">
            <joint name="right_hip_x" type="hinge" axis="1 0 0"
                   range="-0.44 0.09" damping="5" stiffness="10"/>
            <joint name="right_hip_z" type="hinge" axis="0 0 1"
                   range="-1.05 0.61" damping="5" stiffness="10"/>
            <joint name="right_hip_y" type="hinge" axis="0 1 0"
                   range="-1.92 0.35" damping="5" stiffness="20"/>
            <geom name="right_thigh_geom" type="capsule"
                  fromto="0 0 0 0 0.01 -0.34" size="0.06"/>
            <body name="right_shin" pos="0 0.01 -0.4">
              <joint name="right_knee" type="hinge" axis="0 -1 0"
                     range="-2.79 0.02"/>
              <geom name="right_shin_geom" type="capsule"
                    fromto="0 0 0 0 0 -0.3" size="0.049"/>
              <body name="right_foot" pos="0 0 -0.39">
                <joint name="right_ankle_y" type="hinge" axis="0 1 0"
                       range="-0.87 0.87" stiffness="6"/>
                <joint name="right_ankle_x" type="hinge" axis="1 0 0.5"
                       range="-0.87 0.87" stiffness="3"/>
                <geom name="right_foot_geom" type="box"
                      size="0.075 0.05 0.02" pos="0.025 0 0"/>
              </body>
            </body>
          </body>
          <body name="left_thigh" pos="0 0.1 -0.04">
            <joint name="left_hip_x" type="hinge" axis="-1 0 0"
                   range="-0.44 0.09" damping="5" stiffness="10"/>
            <joint name="left_hip_z" type="hinge" axis="0 0 -1"
                   range="-1.05 0.61" damping="5" stiffness="10"/>
            <joint name="left_hip_y" type="hinge" axis="0 1 0"
                   range="-1.92 0.35" damping="5" stiffness="20"/>
            <geom name="left_thigh_geom" type="capsule"
                  fromto="0 0 0 0 -0.01 -0.34" size="0.06"/>
            <body name="left_shin" pos="0 -0.01 -0.4">
              <joint name="left_knee" type="hinge" axis="0 -1 0"
                     range="-2.79 0.02"/>
              <geom name="left_shin_geom" type="capsule"
                    fromto="0 0 0 0 0 -0.3" size="0.049"/>
              <body name="left_foot" pos="0 0 -0.39">
                <joint name="left_ankle_y" type="hinge" axis="0 1 0"
                       range="-0.87 0.87" stiffness="6"/>
                <joint name="left_ankle_x" type="hinge" axis="-1 0 -0.5"
                       range="-0.87 0.87" stiffness="3"/>
                <geom name="left_foot_geom" type="box"
                      size="0.075 0.05 0.02" pos="0.025 0 0"/>
              </body>
            </body>
          </body>
        </body>
      </body>
      <body name="right_upper_arm" pos="0 -0.17 0.06">
        <joint name="right_shoulder1" type="hinge" axis="2 1 1"
               range="-1.48 1.05"/>
        <joint name="right_shoulder2" type="hinge" axis="0 -1 1"
               range="-1.48 1.05"/>
        <geom name="right_upper_arm_geom" type="capsule"
              fromto="0 0 0 0.16 -0.16 -0.16" size="0.04"/>
        <body name="right_lower_arm" pos="0.18 -0.18 -0.18">
          <joint name="right_elbow" type="hinge" axis="0 -1 1"
                 range="-1.57 1.1"/>
          <geom name="right_lower_arm_geom" type="capsule"
                fromto="0.01 0.01 0.01 0.17 0.17 0.17" size="0.031"/>
          <body name="right_hand" pos="0.18 0.18 0.18">
            <geom name="right_hand_geom" type="sphere" size="0.04"/>
          </body>
        </body>
      </body>
      <body name="left_upper_arm" pos="0 0.17 0.06">
        <joint name="left_shoulder1" type="hinge" axis="2 -1 1"
               range="-1.05 1.48"/>
        <joint name="left_shoulder2" type="hinge" axis="0 1 1"
               range="-1.05 1.48"/>
        <geom name="left_upper_arm_geom" type="capsule"
              fromto="0 0 0 0.16 0.16 -0.16" size="0.04"/>
        <body name="left_lower_arm" pos="0.18 0.18 -0.18">
          <joint name="left_elbow" type="hinge" axis="0 -1 -1"
                 range="-1.57 1.1"/>
          <geom name="left_lower_arm_geom" type="capsule"
                fromto="0.01 -0.01 0.01 0.17 -0.17 0.17" size="0.031"/>
          <body name="left_hand" pos="0.18 -0.18 0.18">
            <geom name="left_hand_geom" type="sphere" size="0.04"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <contact>
    <!-- foot-foot is the model's only box-box pair; excluded so both
         tiers share one contact set the device collider supports
         (box-box narrow phase absent; feet crossing is a rare,
         task-irrelevant state) -->
    <exclude body1="left_foot" body2="right_foot"/>
  </contact>
  <actuator>
    <motor name="abdomen_z" joint="abdomen_z" gear="40"/>
    <motor name="abdomen_y" joint="abdomen_y" gear="40"/>
    <motor name="abdomen_x" joint="abdomen_x" gear="40"/>
    <motor name="right_hip_x" joint="right_hip_x" gear="40"/>
    <motor name="right_hip_z" joint="right_hip_z" gear="40"/>
    <motor name="right_hip_y" joint="right_hip_y" gear="120"/>
    <motor name="right_knee" joint="right_knee" gear="80"/>
    <motor name="right_ankle_y" joint="right_ankle_y" gear="20"/>
    <motor name="right_ankle_x" joint="right_ankle_x" gear="20"/>
    <motor name="left_hip_x" joint="left_hip_x" gear="40"/>
    <motor name="left_hip_z" joint="left_hip_z" gear="40"/>
    <motor name="left_hip_y" joint="left_hip_y" gear="120"/>
    <motor name="left_knee" joint="left_knee" gear="80"/>
    <motor name="left_ankle_y" joint="left_ankle_y" gear="20"/>
    <motor name="left_ankle_x" joint="left_ankle_x" gear="20"/>
    <motor name="right_shoulder1" joint="right_shoulder1" gear="20"/>
    <motor name="right_shoulder2" joint="right_shoulder2" gear="20"/>
    <motor name="right_elbow" joint="right_elbow" gear="40"/>
    <motor name="left_shoulder1" joint="left_shoulder1" gear="20"/>
    <motor name="left_shoulder2" joint="left_shoulder2" gear="20"/>
    <motor name="left_elbow" joint="left_elbow" gear="40"/>
  </actuator>
  <sensor>
    <subtreelinvel name="torso_subtreelinvel" body="torso"/>
  </sensor>
</mujoco>
"""


def manipulator_xml(task_name: str) -> str:
  """Counterpart of GetManipulatorXML + XMLRemoveByBodyName
  (dmc/manipulator.h:36-53): a planar arm with a two-finger gripper; the
  prop set (ball/peg + cup/slot receptacles + targets) depends on task."""
  use_peg = task_name in ("bring_peg", "insert_peg")
  insert = task_name in ("insert_ball", "insert_peg")

  ball = """
    <body name="ball" pos="0 0 0">
      <joint name="ball_x" type="slide" axis="1 0 0"
             limited="false" damping="0.01"/>
      <joint name="ball_z" type="slide" axis="0 0 1"
             limited="false" damping="0.01"/>
      <joint name="ball_y" type="hinge" axis="0 1 0"
             limited="false" damping="0.01"/>
      <geom name="ball_geom" type="sphere" size="0.025" mass="0.1"/>
      <site name="ball" pos="0 0 0" size="0.005"/>
    </body>
    <body name="target_ball" pos="0.2 0 0.2">
      <site name="target_ball" pos="0 0 0" size="0.03"/>
    </body>"""
  cup = """
    <body name="cup" pos="-0.2 0 0.2">
      <geom name="cup_left" type="capsule" fromto="-0.05 0 0 -0.05 0 0.08"
            size="0.008" contype="2" conaffinity="1"/>
      <geom name="cup_right" type="capsule" fromto="0.05 0 0 0.05 0 0.08"
            size="0.008" contype="2" conaffinity="1"/>
      <geom name="cup_base" type="capsule" fromto="-0.05 0 0 0.05 0 0"
            size="0.008" contype="2" conaffinity="1"/>
    </body>"""
  peg = """
    <body name="peg" pos="0 0 0">
      <joint name="peg_x" type="slide" axis="1 0 0"
             limited="false" damping="0.01"/>
      <joint name="peg_z" type="slide" axis="0 0 1"
             limited="false" damping="0.01"/>
      <joint name="peg_y" type="hinge" axis="0 1 0"
             limited="false" damping="0.01"/>
      <geom name="peg_geom" type="capsule" fromto="0 0 -0.06 0 0 0.06"
            size="0.015" mass="0.1"/>
      <site name="peg" pos="0 0 0" size="0.005"/>
      <site name="peg_tip" pos="0 0 0.06" size="0.005"/>
      <site name="peg_grasp" pos="0 0 -0.02" size="0.005"/>
      <site name="peg_pinch" pos="0 0 0.02" size="0.005"/>
    </body>
    <body name="target_peg" pos="0.2 0 0.2">
      <site name="target_peg" pos="0 0 0" size="0.005"/>
      <site name="target_peg_tip" pos="0 0 0.06" size="0.005"/>
    </body>"""
  slot = """
    <body name="slot" pos="-0.2 0 0.2">
      <geom name="slot_left" type="box" pos="-0.035 0 0.04"
            size="0.01 0.02 0.08" contype="2" conaffinity="1"/>
      <geom name="slot_right" type="box" pos="0.035 0 0.04"
            size="0.01 0.02 0.08" contype="2" conaffinity="1"/>
      <geom name="slot_base" type="box" pos="0 0 -0.05"
            size="0.045 0.02 0.01" contype="2" conaffinity="1"/>
    </body>"""

  props = peg if use_peg else ball
  if insert:
    props += slot if use_peg else cup

  return f"""
<mujoco model="manipulator">
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <default>
    <joint damping="0.05" limited="true"/>
    <geom friction="0.5" solimp="0.9 0.95 0.001" solref="0.01 1"/>
    <motor ctrllimited="true" ctrlrange="-1 1"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 0" size="2 2 0.1"/>
    <body name="upper_arm" pos="0 0 0.4">
      <joint name="arm_root" type="hinge" axis="0 1 0" limited="false"/>
      <geom name="upper_arm_geom" type="capsule" fromto="0 0 0 0 0 -0.18"
            size="0.02" mass="0.5" contype="4" conaffinity="4"/>
      <body name="middle_arm" pos="0 0 -0.18">
        <joint name="arm_shoulder" type="hinge" axis="0 1 0"
               range="-1.8 1.8"/>
        <geom name="middle_arm_geom" type="capsule" fromto="0 0 0 0 0 -0.15"
              size="0.018" mass="0.3" contype="4" conaffinity="4"/>
        <body name="lower_arm" pos="0 0 -0.15">
          <joint name="arm_elbow" type="hinge" axis="0 1 0"
                 range="-1.8 1.8"/>
          <geom name="lower_arm_geom" type="capsule"
                fromto="0 0 0 0 0 -0.12" size="0.016" mass="0.2"
                contype="4" conaffinity="4"/>
          <body name="hand" pos="0 0 -0.12">
            <joint name="arm_wrist" type="hinge" axis="0 1 0"
                   range="-2.8 2.8"/>
            <geom name="hand_geom" type="capsule" fromto="0 0 0 0 0 -0.03"
                  size="0.015" mass="0.1"/>
            <site name="palm_site" pos="0 0 -0.03" size="0.008"/>
            <site name="grasp" pos="0 0 -0.065" size="0.005"/>
            <site name="pinch" pos="0 0 -0.09" size="0.005"/>
            <body name="finger_body" pos="0.012 0 -0.03">
              <joint name="finger" type="hinge" axis="0 1 0"
                     range="-1.1 0.3"/>
              <geom name="finger_geom" type="capsule"
                    fromto="0 0 0 0 0 -0.05" size="0.007" mass="0.02"/>
              <site name="finger_site" pos="0 0 -0.025" size="0.006"/>
              <body name="fingertip_body" pos="0 0 -0.05">
                <joint name="fingertip" type="hinge" axis="0 1 0"
                       range="-0.6 0.6"/>
                <geom name="fingertip_geom" type="capsule"
                      fromto="0 0 0 0 0 -0.02" size="0.006" mass="0.01"/>
                <site name="fingertip_site" pos="0 0 -0.02" size="0.005"/>
              </body>
            </body>
            <body name="thumb_body" pos="-0.012 0 -0.03">
              <joint name="thumb" type="hinge" axis="0 -1 0"
                     range="-1.1 0.3"/>
              <geom name="thumb_geom" type="capsule"
                    fromto="0 0 0 0 0 -0.05" size="0.007" mass="0.02"/>
              <site name="thumb_site" pos="0 0 -0.025" size="0.006"/>
              <body name="thumbtip_body" pos="0 0 -0.05">
                <joint name="thumbtip" type="hinge" axis="0 -1 0"
                       range="-0.6 0.6"/>
                <geom name="thumbtip_geom" type="capsule"
                      fromto="0 0 0 0 0 -0.02" size="0.006" mass="0.01"/>
                <site name="thumbtip_site" pos="0 0 -0.02" size="0.005"/>
              </body>
            </body>
          </body>
        </body>
      </body>
    </body>
    {props}
  </worldbody>
  <tendon>
    <fixed name="grasp_tendon">
      <joint joint="finger" coef="0.5"/>
      <joint joint="thumb" coef="0.5"/>
    </fixed>
  </tendon>
  <actuator>
    <motor name="arm_root" joint="arm_root" gear="8"/>
    <motor name="arm_shoulder" joint="arm_shoulder" gear="5"/>
    <motor name="arm_elbow" joint="arm_elbow" gear="3"/>
    <motor name="arm_wrist" joint="arm_wrist" gear="1"/>
    <motor name="grasp" tendon="grasp_tendon" gear="1"/>
  </actuator>
  <sensor>
    <touch name="palm_touch" site="palm_site"/>
    <touch name="finger_touch" site="finger_site"/>
    <touch name="thumb_touch" site="thumb_site"/>
    <touch name="fingertip_touch" site="fingertip_site"/>
    <touch name="thumbtip_touch" site="thumbtip_site"/>
  </sensor>
</mujoco>"""


def humanoid_cmu_xml() -> str:
  """CMU-skeleton humanoid (56 actuated DOF, nq=63, nv=62).

  Structural replica of the skeleton the reference's humanoid_CMU domain
  drives (``envpool/mujoco/dmc/humanoid_CMU.h``; dm_control
  ``humanoid_CMU.xml``): CMU mocap joint set and naming
  (``{l,r}{femur,tibia,foot,toes,clavicle,humerus,radius,wrist,hand,
  fingers,thumb}`` + 3-dof spine/neck chain), torque actuation with
  ctrlrange [-1, 1], a ``thorax_subtreelinvel`` sensor, and the body
  names the task reads (head/thorax/{l,r}hand/{l,r}foot). Geometry is a
  proportionate re-derivation, not a copy of the CMU ASF numbers.
  """

  def leg(s: str, y: float) -> str:
    return f"""
      <body name="{s}femur" pos="0 {y * 0.095:.3f} -0.05">
        <joint name="{s}femurrx" axis="0 1 0" range="-160 20"
               damping="5" stiffness="10"/>
        <joint name="{s}femurry" axis="1 0 0" range="-70 70"
               damping="5" stiffness="10"/>
        <joint name="{s}femurrz" axis="0 0 1" range="-60 60"
               damping="5" stiffness="10"/>
        <geom name="{s}femur" type="capsule"
              fromto="0 0 0 0 0 -0.38" size="0.06"/>
        <body name="{s}tibia" pos="0 0 -0.38">
          <joint name="{s}tibiarx" axis="0 1 0" range="-3 170"
                 damping="3"/>
          <geom name="{s}tibia" type="capsule"
                fromto="0 0 0 0 0 -0.38" size="0.045"/>
          <body name="{s}foot" pos="0 0 -0.38">
            <joint name="{s}footrx" axis="0 1 0" range="-45 45"
                   stiffness="6"/>
            <joint name="{s}footrz" axis="0 0 1" range="-20 20"
                   stiffness="3"/>
            <geom name="{s}foot" type="capsule"
                  fromto="-0.03 0 -0.03 0.12 0 -0.03" size="0.03"/>
            <body name="{s}toes" pos="0.14 0 -0.03">
              <joint name="{s}toesrx" axis="0 1 0" range="-45 20"/>
              <geom name="{s}toes" type="capsule"
                    fromto="0 0 0 0.05 0 0" size="0.025"/>
            </body>
          </body>
        </body>
      </body>"""

  def arm(s: str, y: float) -> str:
    return f"""
        <body name="{s}clavicle" pos="0 {y * 0.02:.3f} 0.04">
          <joint name="{s}claviclery" axis="1 0 0" range="-20 20"/>
          <joint name="{s}claviclerz" axis="0 0 1" range="-20 20"/>
          <geom name="{s}clavicle" type="capsule"
                fromto="0 0 0 0 {y * 0.17:.3f} 0.02" size="0.04"/>
          <body name="{s}humerus" pos="0 {y * 0.19:.3f} 0.02">
            <joint name="{s}humerusrx" axis="0 1 0" range="-90 90"/>
            <joint name="{s}humerusry" axis="1 0 0" range="-90 90"/>
            <joint name="{s}humerusrz" axis="0 0 1" range="-90 90"/>
            <geom name="{s}humerus" type="capsule"
                  fromto="0 0 0 0 {y * 0.02:.3f} -0.26" size="0.04"/>
            <body name="{s}radius" pos="0 {y * 0.02:.3f} -0.26">
              <joint name="{s}radiusrx" axis="0 1 0" range="-170 3"/>
              <geom name="{s}radius" type="capsule"
                    fromto="0 0 0 0 0 -0.22" size="0.035"/>
              <body name="{s}wrist" pos="0 0 -0.22">
                <joint name="{s}wristry" axis="0 0 1" range="-90 90"/>
                <geom name="{s}wrist" type="capsule"
                      fromto="0 0 0 0 0 -0.05" size="0.03"/>
                <body name="{s}hand" pos="0 0 -0.06">
                  <joint name="{s}handrx" axis="0 1 0" range="-45 45"/>
                  <joint name="{s}handrz" axis="1 0 0" range="-45 45"/>
                  <geom name="{s}hand" type="sphere" size="0.03"
                        pos="0 0 -0.02"/>
                  <body name="{s}fingers" pos="0 0 -0.05">
                    <joint name="{s}fingersrx" axis="0 1 0"
                           range="-5 90"/>
                    <geom name="{s}fingers" type="capsule"
                          fromto="0 0 0 0 0 -0.04" size="0.02"/>
                  </body>
                  <body name="{s}thumb" pos="0.02 0 -0.03">
                    <joint name="{s}thumbrx" axis="0 1 0" range="-45 45"/>
                    <joint name="{s}thumbrz" axis="0 0 1" range="-45 45"/>
                    <geom name="{s}thumb" type="capsule"
                          fromto="0 0 0 0.03 0 -0.02" size="0.015"/>
                  </body>
                </body>
              </body>
            </body>
          </body>
        </body>"""

  def spine(name: str, z: float, rng: str, half_y: float, r: float,
            inner: str) -> str:
    return f"""
      <body name="{name}" pos="0 0 {z}">
        <joint name="{name}rx" axis="0 1 0" range="{rng}"
               damping="5" stiffness="20"/>
        <joint name="{name}ry" axis="1 0 0" range="{rng}"
               damping="5" stiffness="20"/>
        <joint name="{name}rz" axis="0 0 1" range="{rng}"
               damping="5" stiffness="20"/>
        <geom name="{name}" type="capsule"
              fromto="0 {-half_y} 0 0 {half_y} 0" size="{r}"/>
        {inner}
      </body>"""

  head = """
      <body name="head" pos="0 0 0.09">
        <joint name="headrx" axis="0 1 0" range="-45 45"/>
        <joint name="headry" axis="1 0 0" range="-45 45"/>
        <joint name="headrz" axis="0 0 1" range="-45 45"/>
        <geom name="head" type="sphere" size="0.08" pos="0 0 0.03"/>
      </body>"""
  upperneck = spine("upperneck", 0.08, "-30 30", 0.02, 0.035, head)
  lowerneck = spine("lowerneck", 0.12, "-30 30", 0.03, 0.04, upperneck)
  thorax = spine(
    "thorax", 0.11, "-20 20", 0.07, 0.065,
    arm("l", 1.0) + arm("r", -1.0) + lowerneck,
  )
  upperback = spine("upperback", 0.11, "-30 30", 0.06, 0.06, thorax)
  lowerback = spine("lowerback", 0.10, "-30 45", 0.06, 0.065, upperback)

  gears = {
    "femurrx": 120, "femurry": 80, "femurrz": 60, "tibiarx": 80,
    "footrx": 40, "footrz": 20, "toesrx": 20,
    "claviclery": 40, "claviclerz": 40,
    "humerusrx": 40, "humerusry": 40, "humerusrz": 40, "radiusrx": 40,
    "wristry": 10, "handrx": 10, "handrz": 10, "fingersrx": 5,
    "thumbrx": 5, "thumbrz": 5,
  }
  motors = []
  for side in ("l", "r"):
    for j in ("femurrx", "femurry", "femurrz", "tibiarx", "footrx",
              "footrz", "toesrx"):
      motors.append((side + j, gears[j]))
  for seg, g in (("lowerback", 60), ("upperback", 60), ("thorax", 60),
                 ("lowerneck", 20), ("upperneck", 20), ("head", 20)):
    for ax in ("rx", "ry", "rz"):
      motors.append((seg + ax, g))
  for side in ("l", "r"):
    for j in ("claviclery", "claviclerz", "humerusrx", "humerusry",
              "humerusrz", "radiusrx", "wristry", "handrx", "handrz",
              "fingersrx", "thumbrx", "thumbrz"):
      motors.append((side + j, gears[j]))
  actuators = "\n".join(
    f'    <motor name="{j}" joint="{j}" gear="{g}"/>' for j, g in motors
  )

  return f"""
<mujoco model="humanoid_CMU">
  <option timestep="0.002"/>
  <compiler angle="degree"/>
  <default>
    <joint type="hinge" damping="0.5" armature="0.02" limited="true"
           solimplimit="0 0.99 0.01"/>
    <geom condim="1" friction="0.7" solimp="0.9 0.99 0.003"
          solref="0.015 1"/>
    <motor ctrllimited="true" ctrlrange="-1 1"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 0" size="10 10 0.2"
          condim="3"/>
    <body name="root" pos="0 0 1.0">
      <joint name="root" type="free" limited="false" damping="0"
             armature="0"/>
      <geom name="pelvis" type="capsule" fromto="0 -0.08 0 0 0.08 0"
            size="0.09"/>
      {leg("l", 1.0)}
      {leg("r", -1.0)}
      {lowerback}
    </body>
  </worldbody>
  <actuator>
{actuators}
  </actuator>
  <contact>
    <exclude body1="lclavicle" body2="rclavicle"/>
    <exclude body1="lclavicle" body2="lowerneck"/>
    <exclude body1="rclavicle" body2="lowerneck"/>
    <exclude body1="lwrist" body2="lthumb"/>
    <exclude body1="rwrist" body2="rthumb"/>
    <exclude body1="lfingers" body2="lthumb"/>
    <exclude body1="rfingers" body2="rthumb"/>
  </contact>
  <sensor>
    <subtreelinvel name="thorax_subtreelinvel" body="thorax"/>
  </sensor>
</mujoco>"""


def point_mass_device_xml() -> str:
  """The point_mass replica with its tendon-transmission actuators
  stripped: the env computes the tendon torques itself (the engine has
  joint-transmission actuators only). The JAX package's
  ``_point_mass_device_xml`` (``dmc/device_domains.py:466-471``)."""
  return POINT_MASS_XML.split("<tendon>")[0] + "</mujoco>\n"


# the dm_control model variants, one committed file each
# (``device_model.load_dmc_model``): one per domain, cartpole's pole
# counts, swimmer's sizes and manipulator's four prop sets
DMC_XMLS = {
  "pendulum": PENDULUM_XML,
  "cartpole": cartpole_xml("balance"),
  "cartpole_two_poles": cartpole_xml("two_poles"),
  "cartpole_three_poles": cartpole_xml("three_poles"),
  "point_mass": point_mass_device_xml(),
  "reacher": REACHER_XML,
  "cheetah": CHEETAH_XML,
  "acrobot": ACROBOT_XML,
  "ball_in_cup": BALL_IN_CUP_XML,
  "hopper": DMC_HOPPER_XML,
  "walker": DMC_WALKER_XML,
  "finger": FINGER_XML,
  "swimmer6": swimmer_xml("swimmer6"),
  "swimmer15": swimmer_xml("swimmer15"),
  "fish": FISH_XML,
  "humanoid": DMC_HUMANOID_XML,
  **{f"manipulator_{t}": manipulator_xml(t) for t in (
    "bring_ball", "bring_peg", "insert_ball", "insert_peg")},
  "humanoid_cmu": humanoid_cmu_xml(),
}
