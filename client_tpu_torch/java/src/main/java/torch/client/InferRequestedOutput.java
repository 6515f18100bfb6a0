// Parity: ref src/java/.../InferRequestedOutput.java role.
package torch.client;

public class InferRequestedOutput {
  private final String name;
  private final int classCount;
  private String shmRegion;
  private long shmByteSize;
  private long shmOffset;

  public InferRequestedOutput(String name) { this(name, 0); }

  public InferRequestedOutput(String name, int classCount) {
    this.name = name;
    this.classCount = classCount;
  }

  public void setSharedMemory(String region, long byteSize, long offset) {
    shmRegion = region;
    shmByteSize = byteSize;
    shmOffset = offset;
  }

  public String name() { return name; }

  Json toJson() {
    Json params = Json.object();
    if (shmRegion != null) {
      params.put("shared_memory_region", Json.of(shmRegion));
      params.put("shared_memory_byte_size", Json.of(shmByteSize));
      if (shmOffset != 0)
        params.put("shared_memory_offset", Json.of(shmOffset));
    } else {
      params.put("binary_data", Json.of(true));
    }
    if (classCount > 0)
      params.put("classification", Json.of((long) classCount));
    return Json.object()
        .put("name", Json.of(name))
        .put("parameters", params);
  }
}
