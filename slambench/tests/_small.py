"""A small cell the CPU tests can run: 320x240, P = 192, 1,500 init
features (the scene tracks there; at 160x120 it does not initialise), and
a steady sweep with no blackout that it tracks through."""

from slambench import scene


def steady_mix() -> scene.Mix:
    return scene.Mix(loop_frames=240, speed=0.02, depth_swing=0.1,
                     rotation=0.02, relief=0.5, why="the CPU tests' sweep")


def config(kb8: bool, relost: bool) -> dict:
    cam = {"model": "KannalaBrandt8" if kb8 else "PinHole",
           "height": 240, "width": 320, "fx": 250.0, "fy": 250.0,
           "cx": 159.5, "cy": 119.5}
    if kb8:
        cam.update(k0=-0.01, k1=0.02, k2=-0.01, k3=0.002)
    return {"name": "small", "camera": cam,
            "Config": {"max_points": 192, "max_new_keypoints": 64,
                       "keyframe_every": 5, "rad_per_pixel": 0.004},
            "InitializerConfig": {"max_features": 1500},
            "System": {"seed": 4, "auto_reinitialize": relost,
                       "lost_check_every": 1, "init_check_every": 1}}

