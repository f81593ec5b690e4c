from halogen_tpu.cli.main import main
from halogen_tpu.utils.compile_cache import enable_compile_cache

if __name__ == "__main__":
    enable_compile_cache()
    raise SystemExit(main())
