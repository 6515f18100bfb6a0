// Input tensor with little-endian binary encoding.
// Parity: ref src/java/.../InferInput.java + BinaryProtocol.java roles.
package torch.client;

import java.io.ByteArrayOutputStream;
import java.nio.ByteBuffer;
import java.nio.ByteOrder;
import java.nio.charset.StandardCharsets;

public class InferInput {
  private final String name;
  private final long[] shape;
  private final DataType datatype;
  private byte[] data;
  private String shmRegion;
  private long shmByteSize;
  private long shmOffset;

  public InferInput(String name, long[] shape, DataType datatype) {
    this.name = name;
    this.shape = shape.clone();
    this.datatype = datatype;
  }

  public String name() { return name; }
  public long[] shape() { return shape.clone(); }
  public DataType datatype() { return datatype; }

  public void setData(int[] values) {
    ByteBuffer buf = ByteBuffer.allocate(values.length * 4)
                         .order(ByteOrder.LITTLE_ENDIAN);
    for (int v : values) buf.putInt(v);
    data = buf.array();
  }

  public void setData(long[] values) {
    ByteBuffer buf = ByteBuffer.allocate(values.length * 8)
                         .order(ByteOrder.LITTLE_ENDIAN);
    for (long v : values) buf.putLong(v);
    data = buf.array();
  }

  public void setData(float[] values) {
    ByteBuffer buf = ByteBuffer.allocate(values.length * 4)
                         .order(ByteOrder.LITTLE_ENDIAN);
    for (float v : values) buf.putFloat(v);
    data = buf.array();
  }

  public void setData(double[] values) {
    ByteBuffer buf = ByteBuffer.allocate(values.length * 8)
                         .order(ByteOrder.LITTLE_ENDIAN);
    for (double v : values) buf.putDouble(v);
    data = buf.array();
  }

  /** BYTES elements: 4-byte-LE length prefix framing. */
  public void setData(String[] values) {
    ByteArrayOutputStream out = new ByteArrayOutputStream();
    for (String s : values) {
      byte[] bytes = s.getBytes(StandardCharsets.UTF_8);
      ByteBuffer len =
          ByteBuffer.allocate(4).order(ByteOrder.LITTLE_ENDIAN);
      len.putInt(bytes.length);
      out.writeBytes(len.array());
      out.writeBytes(bytes);
    }
    data = out.toByteArray();
  }

  public void setRawData(byte[] raw) { data = raw; }

  public void setSharedMemory(String region, long byteSize, long offset) {
    shmRegion = region;
    shmByteSize = byteSize;
    shmOffset = offset;
    data = null;
  }

  public boolean isSharedMemory() { return shmRegion != null; }
  public byte[] binaryData() { return data; }

  Json toJson() {
    Json shapeArr = Json.array();
    for (long d : shape) shapeArr.add(Json.of(d));
    Json params = Json.object();
    if (isSharedMemory()) {
      params.put("shared_memory_region", Json.of(shmRegion));
      params.put("shared_memory_byte_size", Json.of(shmByteSize));
      if (shmOffset != 0)
        params.put("shared_memory_offset", Json.of(shmOffset));
    } else {
      params.put("binary_data_size", Json.of((long) data.length));
    }
    return Json.object()
        .put("name", Json.of(name))
        .put("datatype", Json.of(datatype.name()))
        .put("shape", shapeArr)
        .put("parameters", params);
  }
}
