from .xyz import read_xyz_file, read_xyz_string  # noqa: F401
from .config import MqcConfig, read_mqc_file, parse_mqc_string  # noqa: F401
from .adapter import (  # noqa: F401
    DriverConfig,
    config_to_driver,
    config_to_system_geometry,
)
from .json_writer import write_json_output  # noqa: F401
