from ptdn.scene.scene import Scene, DeviceScene  # noqa: F401
